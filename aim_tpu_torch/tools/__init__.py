"""The port's tools, each run as ``python -m aim_tpu_torch.tools.<name>``:
``fuzz_kernels`` (every tier against the exact oracle under non-default
cost models), ``microbench`` (the CUDA probes of ``ops/probes.py``),
``dryrun_multichip`` (a seeded batch over N shards against one shard and
the oracle), ``scaling`` (the main path's pairs/s at 1..N cards),
``bench`` (``bench.py``'s JSON line on the port) and ``timing`` (their
timing library)."""
