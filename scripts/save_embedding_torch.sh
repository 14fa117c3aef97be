#!/usr/bin/env bash
# Stage A through the PyTorch port: extract embeddings for both datasets
# (the twin of save_embedding.sh).  Runs on the card unless REPRO_DEVICE=cpu.
# Pass --checkpoint /path/to/RN50.pt to use real OpenAI weights.
set -euo pipefail
cd "$(dirname "$0")/.."

EXTRA_ARGS=("$@")
DATA_ROOT="${REPRO_DATA_ROOT:-data}"
DEVICE="${REPRO_DEVICE:-cuda}"

for dataset in celeba waterbirds; do
  python -m debiasing_multi_modal_tpu_torch.cli.extract_main \
    --data_dir "$DATA_ROOT" --dataset "$dataset" --embedding_dir embeddings_unnormalized \
    --save --split all --backbone RN50 --device "$DEVICE" \
    ${EXTRA_ARGS[@]+"${EXTRA_ARGS[@]}"}
done
