#!/usr/bin/env python
"""Seed replication of the frontier's accuracy ordering (VERDICT r4 #3).

Every demo_gain in ``frontier.py`` — and hence the shipped-config decisions
(pool vs stride encoder, stem1 vs stem2) — came from ONE trained FCN/DAE
pair per config (seed 0). Repeat-stability of the protocol is known (±0.01
across four re-runs of the same pair), but cross-seed robustness of the
ORDERING was not: on a synthetic task where a 0.7-1.0 point gap decided the
flagship encoder, seed variance was the obvious un-ruled-out confounder.

This driver re-runs scripts/demo_synthetic.py for the four decision-bearing
configs at fresh training seeds and appends one JSON line per run to
DEMO_HISTORY.jsonl (repo root) — the durable artifact the journal and
frontier.py's mean±spread annotations cite.

Configs (the decision-bearing rows of ``frontier.FRONTIER``):
  flagship    : half engine, pool encoder,  stem_pool=1, depth=3, bf16
  stride-stem1: half engine, stride encoder, stem_pool=1, depth=3, bf16
  quarter     : half engine, pool encoder,  stem_pool=2, depth=3, bf16
  composed    : half engine, stride encoder, stem_pool=2, depth=3, bf16

Usage (on the accelerator, idle host):
    python tools/seed_replication.py --seeds 1,2 [--configs flagship,...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "scripts", "demo_synthetic.py")
HISTORY = os.path.join(REPO, "DEMO_HISTORY.jsonl")

CONFIGS = {
    "flagship": ["--engine", "half", "--dae-encoder", "pool",
                 "--dae-stem-pool", "1", "--dae-depth", "3", "--bf16"],
    "stride-stem1": ["--engine", "half", "--dae-encoder", "stride",
                     "--dae-stem-pool", "1", "--dae-depth", "3", "--bf16"],
    "quarter": ["--engine", "half", "--dae-encoder", "pool",
                "--dae-stem-pool", "2", "--dae-depth", "3", "--bf16"],
    "composed": ["--engine", "half", "--dae-encoder", "stride",
                 "--dae-stem-pool", "2", "--dae-depth", "3", "--bf16"],
}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", type=str, default="1,2")
    p.add_argument("--configs", type=str, default=",".join(CONFIGS))
    p.add_argument("--timeout", type=int, default=3600, help="per run, seconds")
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    names = [c for c in args.configs.split(",") if c]
    unknown = [c for c in names if c not in CONFIGS]
    if unknown:
        raise SystemExit(f"unknown configs {unknown}; known: {sorted(CONFIGS)}")

    rc = 0
    for name in names:
        for seed in seeds:
            cmd = [sys.executable, DEMO, "--json", "--seed", str(seed)] + CONFIGS[name]
            t0 = time.time()
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=args.timeout, cwd=REPO)
            line = next(
                (l for l in reversed(res.stdout.splitlines())
                 if l.startswith("{")), None)
            if res.returncode or line is None:
                rec = {"config": name, "seed": seed, "rc": res.returncode,
                       "error": res.stderr[-400:]}
                rc = 1
            else:
                rec = {"config": name, "seed": seed,
                       "wall_s": round(time.time() - t0, 1),
                       **json.loads(line)}
            with open(HISTORY, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
