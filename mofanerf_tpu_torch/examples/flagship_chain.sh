#!/usr/bin/env bash
# The flagship chain on one card, at the JAX scripts' defaults, from the repository's root:
# morphable_flagship trains the full-width model on studydata/faces8 with the JAX run's
# flags (studydata/logs/morphable_flagship/args.txt) for ITERS steps, cut at TRAIN_SECS s
# (a checkpoint every 2000 steps stays), then evaluates it; serve_flagship, fit_quality,
# expression_matrix (on faces8), refine_nerf_corpus, wild_demo (on four photos of the face
# family) and morphable_scaling run on its checkpoint. Each study through run_studies.py
# (its wall time and the kernels' launches in a [STUDY] line). The JSONs, PNGs and logs go
# to OUT; the run directory (checkpoints) to BASE. Training, evaluation and the chain run in
# one call on one machine, as the full-width checkpoint (124 MiB) stays where it was made.
#
#   bash mofanerf_tpu_torch/examples/flagship_chain.sh [ITERS] [TRAIN_SECS] [OUT] [BASE]
set -u
ITERS=${1:-40000}
TRAIN_SECS=${2:-100000}
OUT=${3:-build/chain/out}
BASE=${4:-build/chain/logs}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
date
timeout -s INT "$TRAIN_SECS" python -m mofanerf_tpu_torch.examples.run_studies \
    --out "$OUT/train" --basedir "$BASE" \
    "train morphable_flagship --stage train --device_data --white_bkgd --i_weights 2000 --i_testset 1000000000 --iters $ITERS" \
    > "$OUT/train.log" 2>&1
echo "train rc $?"
date
cp "$BASE/morphable_flagship/train_log.txt" "$BASE/morphable_flagship/args.txt" "$OUT/"
ls "$BASE/morphable_flagship/checkpoints"
python -m mofanerf_tpu_torch.examples.run_studies --out "$OUT" --basedir "$BASE" \
    "eval morphable_flagship --stage eval --white_bkgd" \
    "serve serve_flagship --white_bkgd" \
    "fit fit_quality --white_bkgd" \
    "matrix expression_matrix --data studydata/faces8 --expname morphable_flagship --n_ids 8" \
    "refine_nerf refine_nerf_corpus --white_bkgd" \
    "wild wild_demo --synthetic_photos 4" \
    "scaling morphable_scaling --artifacts_dir $OUT/eval" \
    > "$OUT/rest.log" 2>&1
echo "rest rc $?"
date
grep -h "^\[STUDY\]" "$OUT/train.log" "$OUT/rest.log" | cut -c1-900
tail -3 "$OUT/train_log.txt"
