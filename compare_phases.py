#!/usr/bin/env python3
"""Run the Mamba phases of ``chip_smoke.py`` from several checkouts of
this repository in turns on one card, so that two versions are timed
within one call by the phases' own timers:

    python3 compare_phases.py build/parent . . build/parent

Each argument is the root of a checkout (a parent unpacked with ``git
archive``, for example).  Each runs in a process of its own, in the
order given: it builds its kernels into its own ``build/`` and calls its
own ``chip_smoke.py``'s phases 9-11 (falcon-mamba-7b served), 18-19
(jamba-v0.1-52b served), 23 and 24 (jamba trained on 2 layers, then
falcon-mamba-7b on 8), whose checks stay fatal and whose log lines pass
through.  Exits non-zero if any run fails or no card is visible.
"""
from __future__ import annotations

import subprocess
import sys

RUN = """
import argparse, sys
sys.path[:0] = ["src", "."]
import torch
if not torch.cuda.is_available():
    sys.exit("compare_phases.py: no CUDA device")
import chip_smoke as CS
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.load()
args, dev0 = argparse.Namespace(small=False, phase=None), torch.device(0)
CS.stamp("phases 9-11")
CS.mamba_phases(args, torch, dev0, {}, lambda *a, **k: None)
CS.stamp("phases 18-19")
CS.jamba_phases(args, torch, dev0)
CS.stamp("phases 23-24")
CS.jamba_train_phases(args, torch, dev0)
CS.falcon_train_phase(args, torch, dev0)
CS.stamp("done")
"""


def main() -> int:
    rc = 0
    for tree in sys.argv[1:] or ["."]:
        print(f"=== {tree}", flush=True)
        code = subprocess.run([sys.executable, "-c", RUN], cwd=tree).returncode
        print(f"=== {tree}: exit {code}", flush=True)
        rc = rc or code
    return rc


if __name__ == "__main__":
    sys.exit(main())
