"""The accuracy evidence behind the shipped configurations — ONE table.

``demo_gain`` is the synthetic-demo protocol's test-mIoU improvement
(points) for the config's DAE, under (eps, K) searched on val
(``scripts/demo_synthetic.py``; durable rows in DEMO_HISTORY.jsonl). It
decided the shipped configurations (pool vs stride encoder, stem1 vs
stem2). These are accuracy measurements; they hold on any device. Speed is
measured on the GPU and recorded in PERF.md. Real-CamVid points replace
these at first contact (PARITY.md §6).
"""

from __future__ import annotations

# (short name, demo mIoU gain or None, config note)
FRONTIER: tuple[tuple[str, float | None, str], ...] = (
    ("parity flagship", 9.78,
     "half engine, pool encoder, stem1/d3, fc4096, folded tail — the bench default"),
    ("fast line", 8.82,
     "fc512 + stride encoder, stem1/d3 (fc6 width is the one topology deviation)"),
    ("quarter parity-topology", 7.62,
     "half engine at stem_pool=2, pool encoder, fc4096"),
    ("quarter composed", 6.24,
     "fc512 + stride + stem_pool=2/d3 (--preset fast)"),
    ("general bf16", 10.4,
     "reference-semantics full-res scan, bf16 carry (demo gain is the stem0/d4 DAE's)"),
    ("general strict-f32", None,
     "all-f32 HIGHEST — the adjudicating parity numerics (PARITY.md §5)"),
    ("mirror parity-arch", 7.79,
     "strict-parity conv/pool <-> unpool/conv DAE (models/dae_mirror.py), general engine"),
    ("energy half", 9.81,
     "grad-through-the-DAE update, half engine (unfolded tail — the fold is score-mode algebra)"),
    ("energy quarter", 7.76,
     "grad-through-the-DAE update, half engine at stem_pool=2 (unfolded tail)"),
)


# Seed replication of the frontier's accuracy ORDERING (VERDICT r4 #3).
# The demo_gain column above is the canonical seed-0 protocol; the
# shipped-config decisions it encodes (pool vs stride encoder, stem1 vs
# stem2) were re-run at two fresh training seeds with
# tools/seed_replication.py (durable rows: DEMO_HISTORY.jsonl). Gain
# MAGNITUDE varies with the seed's FCN baseline (a higher-trained baseline
# leaves less refinement headroom: seed1's FCN tests at 0.7743, seed2's at
# 0.8328), so the replicated quantity is the ORDERING, which is monotone
# and identical at every seed: flagship > stride-stem1 > quarter >
# composed. Seeds 1-2 ran after the r5 lane-gather loss change
# (equivalence-pinned, but bf16 training trajectories differ), seed 0 is
# the canonical pre-r5 protocol — orderings agree across both.
# (config, {seed: demo mIoU gain in points})
SEED_REPLICATION: tuple[tuple[str, dict[int, float]], ...] = (
    ("flagship", {0: 9.78, 1: 6.39, 2: 2.99}),
    ("stride-stem1", {0: 8.82, 1: 5.91, 2: 2.43}),
    ("quarter", {0: 7.62, 1: 4.88, 2: 1.56}),
    ("composed", {0: 6.24, 1: 3.66, 2: 0.82}),
)
