#!/usr/bin/env bash
# Local CI gate (same steps as .github/workflows/ci.yml).
# Usage: tools/check.sh   — from the repo root.
set -euo pipefail
cd "$(dirname "$0")/.."

export JAX_PLATFORMS=cpu

echo "== compile-check all sources =="
python -m compileall -q poulpy_tpu tests examples bench.py bench_full.py \
  bench_sweep.py bench_schemes.py chip_smoke.py __graft_entry__.py

echo "== pytest (CPU, 8 virtual devices) =="
python -m pytest tests/ -q -m 'not slow'

echo "== bench harness smoke (tiny batch, CPU) =="
BENCH_BATCH=16 BENCH_ITERS=2 timeout 900 python bench.py >/dev/null

echo "CHECK OK"
