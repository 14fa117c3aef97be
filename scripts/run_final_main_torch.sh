#!/usr/bin/env bash
# Stage B through the PyTorch port: the best Waterbirds configuration (the
# twin of run_final_main.sh, with its flags).  Runs on the card unless
# REPRO_DEVICE=cpu; REPRO_DATA_ROOT moves the data root (default: data).
set -euo pipefail
cd "$(dirname "$0")/.."

epochs=100
dataset="waterbirds"
DATA_ROOT="${REPRO_DATA_ROOT:-data}"
data_dir="${DATA_ROOT}/waterbirds/waterbird_complete95_forest2water2"
emb_dir="${DATA_ROOT}/embeddings_unnormalized/${dataset}"

epochs_feature_learning=40
lr_decay_epochs='90,95'

tl_method="adapter_reg_seq_alter"
target="class"
non_target="spurious"

# Best hyper-parameters in waterbirds.
bs=1024
bsr=256
lr=1.0
lrr=1.0

python -m debiasing_multi_modal_tpu_torch.cli.train_main \
  --epochs ${epochs} --learning_rate ${lr} --batch_size ${bs} \
  --epochs_feature_learning ${epochs_feature_learning} \
  --learning_rate_reg ${lrr} --batch_size_reg ${bsr} \
  --dataset ${dataset} \
  --text_embedding_dir "${emb_dir}/clip_${target}.json" \
  --text_spurious_embedding_dir "${emb_dir}/clip_${non_target}.json" \
  --text_group_embedding_dir "${emb_dir}/clip_group.json" \
  --image_embedding_dir "${emb_dir}/RN50/clip.npz" \
  --data_dir "${data_dir}" \
  --tl_method ${tl_method} \
  --train_target ${target} \
  --watch_batch_results --print_freq 1 --save_results \
  --warm_reg --lr_decay_rate 0.1 --lr_decay_epochs ${lr_decay_epochs} \
  --add_adapter --random_seed 42 --device "${REPRO_DEVICE:-cuda}" "$@"
