"""aim-tpu-torch: the PyTorch / CUDA port of aim-tpu for NVIDIA Hopper.

A second package beside ``aim_tpu`` (the JAX reference, which stays
unchanged).  It runs the same alignment pipeline with the same frozen
``aim_tpu.config.AlignConfig`` and the same framework-free host runtime
(``aim_tpu.native``: parser, oracle, record decoder, output emitter); the
device kernels are hand-written CUDA C++ for ``sm_90a`` under
``aim_tpu_torch/csrc/``, built with ``nvcc`` at first use.

Ported so far: the short-read tiers of WFA / WFA-adaptive (the reference's
``ops/wfa_pallas2.py``; the main path
``python -m aim_tpu_torch.cli wfa -l 100 -e 0.01 -b -r``), NW
(``ops/nw_pallas.py``), SWG (``ops/swg_pallas.py``) and GenASM
(``ops/genasm_pallas.py``), and the WFA long-read tier
(``ops/wfa_pallas_long.py``, reads of 1-16 kbp).  Every other
configuration raises ``NotImplementedError`` naming its ROADMAP item.

Importing this package never builds a kernel and never needs CUDA.
"""

__version__ = "0.1.0"
