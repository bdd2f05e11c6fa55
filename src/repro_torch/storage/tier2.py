"""Tier-2 backing store simulator (paper §V-B).

Converts tier-2 traffic counts (from :mod:`repro_torch.storage.tiered_store`) into
service times / rates using the fitted HDD behavioral models, and provides
the μ2 values consumed by the queuing network. This is the piece that made
the paper's measured performance "include the cost of page misses" (§I).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

from repro_torch.core.device_models import DeviceModel, fit_hdd_model, fit_nvme_model

__all__ = ["Tier2Sim", "default_tier2", "Tier1Sim", "default_tier1"]


@lru_cache(maxsize=None)
def _hdd(read: bool) -> DeviceModel:
    return fit_hdd_model(read=read)


@lru_cache(maxsize=None)
def _nvme(read: bool) -> DeviceModel:
    return fit_nvme_model(read=read)


@dataclasses.dataclass(frozen=True)
class Tier2Sim:
    """Shared HDD array behind the distributed cache.

    Layout parameters follow §V-B: stripe_count (X2), stripe_size (X4),
    file_size (X5), n_processes (X1). Stripes/disk (X3) is derived.
    """

    n_processes: int = 4
    stripe_count: int = 8
    stripe_size: int = 524288
    file_size: int = 400 << 30

    def _x3(self) -> float:
        return max(self.file_size / (self.stripe_size * self.stripe_count), 1.0)

    def full_file_time(self, *, read: bool) -> float:
        """Model prediction for one parallel pass over the whole file — the
        regime the §V-B campaigns were trained on."""
        m = _hdd(read)
        t = m.total_time(
            x1=float(self.n_processes),
            x2=float(self.stripe_count),
            x3=self._x3(),
            x4=float(self.stripe_size),
            x5=float(self.file_size),
        )
        floor = self.file_size / (1.5e8 * self.stripe_count)
        return max(t, floor)

    def total_time(self, n_stripes: float, *, read: bool) -> float:
        """Time to move ``n_stripes`` stripes at the model's mean per-stripe
        rate (§V-B: "compute the mean read/write time per stripe from total
        time" — avoids extrapolating the fit far below its training range).
        """
        per_stripe = self.full_file_time(read=read) / (
            self.file_size / self.stripe_size)
        return n_stripes * per_stripe

    def mu2(self, *, read: bool = True, n_stripes: float = 1024.0) -> float:
        """Mean miss service rate (stripes/sec) — μ2 for the queuing model."""
        return n_stripes / max(self.total_time(n_stripes, read=read), 1e-12)


@dataclasses.dataclass(frozen=True)
class Tier1Sim:
    """Per-process NVMe cache device (§V-A) — provides μ1 for queuing."""

    n_client_threads: int = 16
    request_size: int = 512
    address_range: int = 32 << 30

    def total_time(self, n_requests: float, *, read: bool) -> float:
        m = _nvme(read)
        t = m.total_time(
            x1=float(self.n_client_threads),
            x3=float(self.request_size),
            x4=float(n_requests),
            x5=float(self.address_range),
        )
        floor = n_requests * self.request_size / 3.5e9
        return max(t, floor)

    def mu1(self, *, read: bool = True, n_requests: float = 1e5) -> float:
        return n_requests / self.total_time(n_requests, read=read)


def default_tier2() -> Tier2Sim:
    return Tier2Sim()


def default_tier1() -> Tier1Sim:
    return Tier1Sim()
