#!/usr/bin/env bash
# Generic scene reconstruction driver on the PyTorch port (pram_tpu_torch),
# the counterpart of scripts/reconstruct_scene.sh with the same arguments and
# environment variables: extract features, match covisibility pairs,
# triangulate with reference poses, then build landmarks. Images may be JPEG,
# PNG or .npy.
#
# Usage: reconstruct_scene_torch.sh DATASET_DIR LANDMARK_DIR REF_MODEL_DIR PAIRS_TXT [N_CLUSTER] [MODE] [METHOD]
#
# Environment: SFD2_WEIGHTS, GML_WEIGHTS (as the JAX script), and DEVICE
# (cuda by default; DEVICE=cpu runs the steps that use a device on the CPU).
# Triangulation runs on the host and takes no device.
set -euo pipefail

DATASET_DIR=$1
LANDMARK_DIR=$2
REF_MODEL=$3
PAIRS=$4
N_CLUSTER=${5:-16}
MODE=${6:-xz}
METHOD=${7:-birch}

FEATS=$LANDMARK_DIR/feats-sfd2.h5
MATCHES=$LANDMARK_DIR/matches-gml.h5
mkdir -p "$LANDMARK_DIR"

python -m pram_tpu_torch.cli.extract_features \
    --image_dir "$DATASET_DIR" --export_fn "$FEATS" --conf sfd2 \
    ${SFD2_WEIGHTS:+--weight_path "$SFD2_WEIGHTS"} \
    ${DEVICE:+--device "$DEVICE"}

python -m pram_tpu_torch.cli.match_features \
    --pairs "$PAIRS" --features "$FEATS" --export_fn "$MATCHES" --conf gml \
    ${GML_WEIGHTS:+--weight_path "$GML_WEIGHTS"} \
    ${DEVICE:+--device "$DEVICE"}

python -m pram_tpu_torch.cli.triangulate \
    --reference_model "$REF_MODEL" --features "$FEATS" \
    --pairs "$PAIRS" --matches "$MATCHES" --output "$LANDMARK_DIR/model"

python -m pram_tpu_torch.cli.build_map \
    --model "$LANDMARK_DIR/model" --features "$FEATS" \
    --output "$LANDMARK_DIR" --n_cluster "$N_CLUSTER" \
    --cluster_mode "$MODE" --cluster_method "$METHOD" \
    ${DEVICE:+--device "$DEVICE"}
