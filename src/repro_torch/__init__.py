"""PyTorch / CUDA port of the two-tier storage performance model.

Mirrors the JAX reference package ``repro`` module for module (same paths,
same public names) and runs its main path, ``repro_torch.sim.simulate``,
on an NVIDIA H100: host-side traffic and §III mapping, the tier-1 request
loop as a hand-written CUDA kernel, and the §V queuing reports in numpy.
Entry points take ``device=None``, meaning the card; pass ``device="cpu"``
for the plain PyTorch path.
"""
