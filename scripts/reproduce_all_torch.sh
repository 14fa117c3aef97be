#!/usr/bin/env bash
# ONE-COMMAND reproduction of the reference's headline numbers through the
# PyTorch port (debiasing_multi_modal_tpu_torch), the twin of reproduce_all.sh.
#
#   bash scripts/reproduce_all_torch.sh [/path/to/RN50.pt]
#
# Chain: Stage-A extraction (both datasets) -> headline sweeps (WB grid x 3
# seeds, CA bsr grid x 3 seeds, stacked rows) -> the eight ablation cells ->
# ablation tables -> automated diff vs BASELINE.md (exits non-zero if any
# produced cell misses the 0.5 pt north-star band).  Every step runs on the
# card unless REPRO_DEVICE=cpu; without a card a cuda step raises.
#
# Environment knobs (all optional; defaults reproduce the real-asset chain):
#   REPRO_DATA_ROOT    dataset + embedding root (default: data)
#   REPRO_RESULT_ROOT  sweep CSV output dir (default: results_iterative)
#   REPRO_CKPT         the RN50 checkpoint (default: ~/.cache/clip/RN50.pt)
#   REPRO_DEVICE       cuda (default) or cpu
#   REPRO_EXTRACT_ARGS extra extract_main args (e.g. "--host_resolution 64")
#   REPRO_SWEEP_ARGS   extra sweep_main args (e.g. "--epochs 4 ...")
#   REPRO_CHECK_ARGS   extra check_vs_baseline args (e.g. "--structural")
#   REPRO_ABLATIONS=0  skip the eight ablation cells
#   REPRO_RUN_NOTEBOOKS=1  also execute the three port notebooks (nbclient)
# reproduce_all.sh's REPRO_RUN_ORACLE has no twin here: it runs the reference's
# own trainer against the JAX package.  The port's Stage B is held to the JAX
# package's CSVs byte for byte instead (tests/test_torch_reproduce.py,
# tests/test_torch_sweep.py).  The synthetic rehearsal
# (tests/test_torch_reproduce.py) runs this chain end to end on
# scripts/make_synthetic_fixture.py --skip_checkpoint plus
# scripts/make_synthetic_checkpoint_torch.py.
set -euo pipefail
cd "$(dirname "$0")/.."

ROOT="${REPRO_DATA_ROOT:-data}"
RESULTS="${REPRO_RESULT_ROOT:-results_iterative}"
DEVICE="${REPRO_DEVICE:-cuda}"
read -r -a EXTRACT_EXTRA <<< "${REPRO_EXTRACT_ARGS:-}" || true
read -r -a SWEEP_EXTRA <<< "${REPRO_SWEEP_ARGS:-}" || true
read -r -a CHECK_EXTRA <<< "${REPRO_CHECK_ARGS:-}" || true
SWEEP_EXTRA+=(--result_root "$RESULTS")
export REPRO_DATA_ROOT="$ROOT" REPRO_DEVICE="$DEVICE"

stage() {  # wall seconds of each stage, for the caller to read
  echo "stage $1: $(( $(date +%s%N) / 1000000 - $2 )) ms"
}
now() { echo $(( $(date +%s%N) / 1000000 )); }
t_chain=$(now)

CKPT="${1:-${REPRO_CKPT:-$HOME/.cache/clip/RN50.pt}}"
CKPT_ARGS=()
if [ -f "$CKPT" ]; then
  CKPT_ARGS=(--checkpoint "$CKPT")
else
  echo "NOTE: $CKPT not found; extract_main runs RN50 with seeded random weights" \
       "(chance-level accuracies: a structural run). Nothing is downloaded." >&2
fi

# ---- Stage A: embeddings for both datasets
t=$(now)
bash scripts/save_embedding_torch.sh ${CKPT_ARGS[@]+"${CKPT_ARGS[@]}"} \
  ${EXTRACT_EXTRA[@]+"${EXTRACT_EXTRA[@]}"}
stage extract "$t"

# ---- Stage B: headline sweeps (results land in $RESULTS/)
t=$(now)
bash scripts/run_sweep_wb_torch.sh "${SWEEP_EXTRA[@]}"
stage sweep_wb "$t"
t=$(now)
bash scripts/run_sweep_ca_torch.sh "${SWEEP_EXTRA[@]}"
stage sweep_ca "$t"

# ---- ablation rows used by check_vs_baseline (the exact configurations the
# reference's ablations notebook reads, cells 7-21; reproduce_all.sh's list)
if [ "${REPRO_ABLATIONS:-1}" = "1" ]; then
t=$(now)
emb="$ROOT/embeddings_unnormalized/waterbirds"
common=(--dataset waterbirds
  --text_embedding_dir "$emb/clip_class.json"
  --text_spurious_embedding_dir "$emb/clip_spurious.json"
  --text_group_embedding_dir "$emb/clip_group.json"
  --image_embedding_dir "$emb/RN50/clip.npz"
  --data_dir "$ROOT/waterbirds/waterbird_complete95_forest2water2"
  --num_iter 3 --random_seeds 42,32,22 --lr_decay_rate 0.1
  --epochs 100 --lr_decay_epochs 90,95 --device "$DEVICE")
two_phase=(--epochs_feature_learning 40 --warm_reg --lr_multiple 1.0)
sweep=(python -m debiasing_multi_modal_tpu_torch.cli.sweep_main "${common[@]}")
"${sweep[@]}" \
  --tl_method linear_probing --lr_list 1 --bs_list 512 --bsr_list 64 "${SWEEP_EXTRA[@]}"
"${sweep[@]}" \
  --tl_method adapter --lr_list 10 --bs_list 1024 --bsr_list 64 "${SWEEP_EXTRA[@]}"
"${sweep[@]}" "${two_phase[@]}" \
  --tl_method adapter_reg --lr_list 10 --bs_list 512 --bsr_list 256 "${SWEEP_EXTRA[@]}"
"${sweep[@]}" "${two_phase[@]}" \
  --tl_method adapter_reg --use_cls_prompt_in_reg \
  --lr_list 10 --bs_list 512 --bsr_list 64 "${SWEEP_EXTRA[@]}"
"${sweep[@]}" "${two_phase[@]}" \
  --tl_method adapter_reg_seq --add_adapter \
  --lr_list 1 --bs_list 1024 --bsr_list 64 "${SWEEP_EXTRA[@]}"
"${sweep[@]}" "${two_phase[@]}" \
  --tl_method adapter_reg_seq --use_cls_prompt_in_reg --add_adapter \
  --lr_list 10 --bs_list 512 --bsr_list 256 "${SWEEP_EXTRA[@]}"
"${sweep[@]}" "${two_phase[@]}" \
  --tl_method adapter_reg_seq_alter \
  --lr_list 10 --bs_list 512 --bsr_list 256 "${SWEEP_EXTRA[@]}"
"${sweep[@]}" "${two_phase[@]}" \
  --tl_method adapter_reg_seq_alter --balance_val --add_adapter \
  --lr_list 1 --bs_list 1024 --bsr_list 512 "${SWEEP_EXTRA[@]}"
stage ablations "$t"
fi

# ---- report tables + automated acceptance diff (standard library only:
# the same scripts serve the JAX chain)
t=$(now)
python scripts/ablation_tables.py "$RESULTS"
python scripts/check_vs_baseline.py "$RESULTS" ${CHECK_EXTRA[@]+"${CHECK_EXTRA[@]}"}
stage report "$t"

# ---- optional: execute the three port notebooks on the CPU
if [ "${REPRO_RUN_NOTEBOOKS:-0}" = "1" ]; then
  RUN_NB_TESTS=1 python -m pytest tests/test_torch_notebooks.py -q
fi
stage chain "$t_chain"
