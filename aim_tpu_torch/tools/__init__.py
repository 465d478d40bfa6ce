"""The port's tools, each run as ``python -m aim_tpu_torch.tools.<name>``:
``fuzz_kernels`` (every tier against the exact oracle under non-default
cost models), ``microbench`` (the CUDA probes of ``ops/probes.py``) and
``timing`` (their timing library)."""
