"""aim-tpu-torch: the PyTorch / CUDA port of aim-tpu for NVIDIA Hopper.

A second package beside ``aim_tpu`` (the JAX reference, which stays
unchanged).  It runs the same alignment pipeline with its own copies of
the reference's host modules -- ``config`` (the frozen ``AlignConfig``),
``datagen``, the CLI's parser and ``native`` (parser, exact oracles,
record decoders, output emitter; g++-built at first use into
``aim_tpu_torch/_build/``) -- and imports nothing of ``aim_tpu``.  The
device kernels are hand-written CUDA C++ for ``sm_90a`` under
``aim_tpu_torch/csrc/``, built with ``nvcc`` at first use.

Ported so far: the short-read tiers of WFA / WFA-adaptive (the reference's
``ops/wfa_pallas2.py``; the main path
``python -m aim_tpu_torch.cli wfa -l 100 -e 0.01 -b -r``), NW
(``ops/nw_pallas.py``), SWG (``ops/swg_pallas.py``) and GenASM
(``ops/genasm_pallas.py``), the WFA long-read tier
(``ops/wfa_pallas_long.py``, reads of 1-16 kbp), and the streamed NW/SWG
long-read tier (``ops/nwswg_pallas_long.py``) with its band-retry ladder
and the GenASM long tier on it (``ops/genasm_long.py``).  Every other
configuration, and every one under ``backend="xla"``, runs on the exact
tiers: the dense NW, SWG and WFA tiers in plain PyTorch on the device
(the reference's ``ops/{nw,swg,wfa}_xla.py``) and GenASM's host tier.
The reference's two TPU probes (``tools/microbench_mosaic.py``) are CUDA
probes (``ops/probes.py``, ``csrc/probes.cu``); the tools run as
``python -m aim_tpu_torch.tools.<name>`` (``fuzz_kernels``,
``microbench``; ``timing`` is their timing library).

Importing this package never builds a kernel and never needs CUDA.
"""
__version__ = "0.1.0"
