#!/bin/bash
# Train on the reference demo dataset (105 samples x 8,451 SNPs) and check
# the outputs against the published expected files -- this engine's
# equivalent of the reference's demo workflow.
#
# DEMO_DATA can point at any copy of the demo BED fileset; it defaults to
# the fixtures vendored in this repo (demo/data, demo/expected).
set -e
HERE=$(cd "$(dirname "$0")" && pwd)
DEMO_DATA=${DEMO_DATA:-$HERE/data/demo_data.bed}
EXPECTED_DIR=${EXPECTED_DIR:-$HERE/expected}
OUT=${OUT:-./demo_outputs}

echo "Running Neural ADMIXTURE (JAX) on demo data..."
start=$(date +%s)
python -m neural_admixture_tpu train --k 7 --data_path "$DEMO_DATA" \
    --save_dir "$OUT" --name demo_run --epochs 5 --seed 42 --threads 4
end=$(date +%s)
echo "Demo run in $((end - start)) seconds."
echo "Running diagnostics..."
# The third arg enables the log-likelihood gate (ours must be >= the
# expected outputs' LL on the demo data); set -e fails the script on it.
python "$(dirname "$0")/run_diagnostics.py" "$OUT" "$EXPECTED_DIR" "$DEMO_DATA"
