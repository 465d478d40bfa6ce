"""The entries a traffic mix drives, chosen by the mix's `entry` key.

- `cli_file`: `aim_tpu_torch.cli.main` in process, file to file, as a
  user runs `python -m aim_tpu_torch.cli`.  The pool is `files` pair files
  of `pairs_per_file` pairs, written at set-up; batch i aligns file
  i mod `files` into that file's output, which the check reads after the
  window.
- `api_batch`: `aim_tpu_torch.api.align` on in-memory arrays, as a read
  mapper calls it.  The pool is `pool_batches` batches of
  `pairs_per_batch` pairs; batch i takes the pool's batches in an order
  drawn from the seed, and the results of `check_batches` of them, drawn
  from the seed, are kept for the check.

Each entry runs in one of three modes: `gpu` (the program on the cards),
`rehearse` (the program's plain paths on the CPU, for rehearsal only) and
`control` (the plain reference in the program's place, breaking a
guarantee the configuration states: the control the comparison has to
fail).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import io
import multiprocessing
import os
import re

import numpy as np

import check
import gen
from reference import emit

_LINES = {
    "parse_ms": re.compile(r"Parsed \d+ pairs in ([0-9.]+) ms"),
    "load_ms": re.compile(r"CPU-GPU: ([0-9.]+) ms"),
    "kernel_ms": re.compile(r"GPU Kernel: ([0-9.]+) ms"),
    "retrieve_ms": re.compile(r"GPU-CPU: ([0-9.]+) ms"),
}


def cli_config(config):
    """The AlignConfig the program's CLI derives from the config's flags."""
    from aim_tpu_torch import cli
    args = cli.build_parser().parse_args(
        config["cli"] + ["-i", "-", "-n", "1"])
    return cli.config_from_args(args)


def _reference_part(module, config, control, pats, txts, plens, tlens):
    return importlib.import_module(module).run(pats, txts, plens, tlens,
                                               config, control)


class _Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx["config"]
        self.traffic = ctx["traffic"]
        self.mode = ctx["mode"]
        self.chips = ctx["chips"]
        self.seed = ctx["seed"]
        self.workdir = ctx["workdir"]
        self.reference = importlib.import_module(
            "reference." + self.config["reference"])
        self.extra = {}

    def devices(self):
        if self.mode == "rehearse":
            return ["cpu"] * self.chips
        from aim_tpu_torch.parallel import devices
        return devices(self.chips)

    def _reference(self, pats, txts, plens, tlens, control=False):
        """The plain reference module the configuration names, on these
        pairs: (scores, ops, begin, end, extra), `extra` being what its
        `work` counts from.  The control (the reference breaking a
        guarantee the configuration states) runs on processes of its own,
        one a core, since it stands in for the program on every pair of a
        batch."""
        n = len(plens)
        procs = min(os.cpu_count() or 1, 16) if control else 1
        if procs == 1 or n < 2 * procs:
            return self.reference.run(pats, txts, plens, tlens, self.config,
                                      control)
        step = -(-n // procs)
        parts = [(pats[lo:lo + step], txts[lo:lo + step],
                  plens[lo:lo + step], tlens[lo:lo + step])
                 for lo in range(0, n, step)]
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(len(parts)) as pool:
            outs = pool.starmap(functools.partial(
                _reference_part, self.reference.__name__, self.config,
                control), parts)
        return tuple(None if x[0] is None else np.concatenate(x)
                     for x in zip(*outs))

    def _generate(self, n, stream):
        c = self.config
        return gen.generate(n, c["read_length"], c["error"], self.seed,
                            stream, size=c["read_size"])

    def work(self, unit):
        """(bytes, int32 ops) of one pool unit by the reference module's
        frozen counts, from the mean `extra` of the pairs the reference
        checked; None where it counts none."""
        plens, tlens = self.lengths[unit]
        count = getattr(self.reference, "work", None)
        extra = [v for v in self.extra.values() if v is not None]
        if not extra or count is None:
            return None
        mean = float(np.mean(np.concatenate(extra)))
        return count(plens, tlens, np.full(len(plens), mean))


class CliFile(_Entry):
    def setup(self):
        t = self.traffic
        n = self.ctx.get("pairs") or t["pairs_per_file"]
        self.n = n
        self.paths, self.lengths, self.samples, self.full = [], [], [], []
        for f in range(t["files"]):
            pats, txts, plens, tlens = self._generate(n, f)
            path = os.path.join(self.workdir, f"pool{f}.txt")
            gen.write_pairs(path, pats, txts, plens, tlens)
            k = min(n, t["check_pairs_per_file"])
            pick = gen.rng(self.seed, 1000 + f).choice(n, k, replace=False)
            pick[0] = int(np.argmax(tlens))       # the longest text too
            pick = np.unique(pick)
            self.samples.append((pick, pats[pick], txts[pick], plens[pick],
                                 tlens[pick]))
            self.paths.append(path)
            self.lengths.append((plens, tlens))
            if self.mode == "control":
                self.full.append((pats, txts, plens, tlens))
        self.outs = [os.path.join(self.workdir, f"out{f}.txt")
                     for f in range(t["files"])]
        self.used = set()
        if self.mode == "rehearse":
            self.cfg = cli_config(self.config)

    def _argv(self, inp, out):
        return self.config["cli"] + ["-i", inp, "-o", out, "-n", str(self.n),
                                     "-d", str(self.chips)]

    def _run(self, unit, out):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if self.mode == "gpu":
                from aim_tpu_torch import cli
                rc = cli.main(self._argv(self.paths[unit], out))
            elif self.mode == "rehearse":
                from aim_tpu_torch.api import align_file
                align_file(self.paths[unit], out, self.n, self.cfg,
                           device=self.devices(), verbose=True)
                rc = 0
            else:
                res = self._reference(*self.full[unit], control=True)
                emit.write(out, res[0], res[1], res[2], res[3],
                           self.config["backtrace"])
                rc = 0
        return rc, buf.getvalue()

    def control_units(self):
        return len(self.paths)

    def warm(self):
        rc, _ = self._run(0, os.path.join(self.workdir, "warm.txt"))
        if rc != 0:
            raise RuntimeError(f"warm-up batch returned {rc}")

    def batch(self, i):
        unit = i % len(self.paths)
        self.used.add(unit)
        rc, text = self._run(unit, self.outs[unit])
        rec = {"pairs": self.n, "unit": unit, "failed": rc != 0}
        for key, pat in _LINES.items():
            m = pat.search(text)
            rec[key] = float(m.group(1)) if m else None
        return rec

    def release(self):
        self.full = []

    def check(self):
        parts = []
        for unit in sorted(self.used):
            pick, pats, txts, plens, tlens = self.samples[unit]
            scores, ops, begin, end, extra = self._reference(
                pats, txts, plens, tlens)
            self.extra[unit] = extra
            parts.append(check.file_counts(
                self.outs[unit], self.n, pick, (scores, ops, begin, end),
                self.config["backtrace"]))
        return parts


class ApiBatch(_Entry):
    def setup(self):
        t = self.traffic
        per = self.ctx.get("pairs") or t["pairs_per_batch"]
        pool = t["pool_batches"]
        self.n = per
        pats, txts, plens, tlens = self._generate(per * pool, 0)
        self.pool = [(pats[b * per:(b + 1) * per], txts[b * per:(b + 1) * per],
                      plens[b * per:(b + 1) * per],
                      tlens[b * per:(b + 1) * per]) for b in range(pool)]
        self.lengths = [(p[2], p[3]) for p in self.pool]
        self.order = gen.rng(self.seed, 2).permutation(pool)
        k = min(pool, t["check_batches"])
        self.sampled = set(gen.rng(self.seed, 1000).choice(
            pool, k, replace=False).tolist())
        if self.mode == "control":
            self.order = np.array(sorted(self.sampled))
        self.kept = {}
        from aim_tpu_torch import api
        self.api = api
        self.cfg = cli_config(self.config)
        self.devs = None if self.mode == "control" else self.devices()

    def _run(self, unit):
        p = self.pool[unit]
        if self.mode == "control":
            r = self._reference(*p, control=True)
            return r[0], r[1], r[2], r[3], 0.0, 0.0, 0.0
        res = self.api.align(*p, self.cfg, device=self.devs)
        return (res.scores, res.ops, res.begin, res.end, res.t_load,
                res.t_kernel, res.t_retrieve)

    def control_units(self):
        return len(self.sampled)

    def warm(self):
        self._run(int(self.order[0]))

    def batch(self, i):
        unit = int(self.order[i % len(self.order)])
        out = self._run(unit)
        if unit in self.sampled:
            self.kept[unit] = out[:4]
        return {"pairs": self.n, "unit": unit, "failed": False,
                "parse_ms": None, "load_ms": out[4] * 1e3,
                "kernel_ms": out[5] * 1e3, "retrieve_ms": out[6] * 1e3}

    def release(self):
        self.api = None

    def check(self):
        parts = []
        for unit in sorted(self.kept):
            ref = self._reference(*self.pool[unit])
            self.extra[unit] = ref[4]
            parts.append(check.result_counts(self.kept[unit], ref[:4],
                                             self.config["backtrace"]))
        return parts


ENTRIES = {"cli_file": CliFile, "api_batch": ApiBatch}


def make(ctx):
    return ENTRIES[ctx["traffic"]["entry"]](ctx)
