"""The paper's examples through the port's public API.

Each module runs as ``python -m repro_torch.examples.<name>`` on the card
(``--device cpu`` for the plain PyTorch path) and ends with a line
``<name> OK``: ``quickstart``, ``end_to_end``, ``mrc_curve``,
``stream_replay``, ``fault_timeline``, ``configure_from_model``,
``burst_response``, ``warmup_curve`` and ``train_tiered``.
"""
