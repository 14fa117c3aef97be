#!/usr/bin/env bash
# CelebA sweep grid through the PyTorch port (the twin of run_sweep_ca.sh):
# bs 1024 x bsr in {4,8,16} x lr 0.1, lr_multiple 10, balanced val, 2 seeds.
# Runs on the card unless REPRO_DEVICE=cpu.
set -euo pipefail
cd "$(dirname "$0")/.."

dataset="celeba"
DATA_ROOT="${REPRO_DATA_ROOT:-data}"
data_dir="${DATA_ROOT}/celeba"
emb_dir="${DATA_ROOT}/embeddings_unnormalized/${dataset}"

python -m debiasing_multi_modal_tpu_torch.cli.sweep_main \
  --epochs 65 --epochs_feature_learning 40 \
  --dataset ${dataset} \
  --text_embedding_dir "${emb_dir}/clip_class.json" \
  --text_spurious_embedding_dir "${emb_dir}/clip_spurious.json" \
  --text_group_embedding_dir "${emb_dir}/clip_group.json" \
  --image_embedding_dir "${emb_dir}/RN50/clip.npz" \
  --data_dir "${data_dir}" \
  --tl_method adapter_reg_seq_alter --train_target class \
  --warm_reg --lr_decay_rate 0.1 --lr_decay_epochs 62,64 \
  --add_adapter --balance_val \
  --num_iter 2 --random_seeds 42,32 \
  --lr_list 0.1 --bs_list 1024 --bsr_list 4,8,16 \
  --lr_multiple 10.0 --device "${REPRO_DEVICE:-cuda}" "$@"
