"""PyTorch/CUDA port of the vLLM-Omni reproduction (``repro``, in JAX).

Same module layout as ``repro`` wherever a reader needs a counterpart
(``repro_torch/engine/runner.py`` <-> ``repro/engine/runner.py``).  The
attention kernels of the serving path are hand-written CUDA C++ for
Hopper (``kernels/csrc``); every entry point runs on the card unless the
caller passes ``device="cpu"``.  Imports torch, numpy and the standard
library only.
"""
