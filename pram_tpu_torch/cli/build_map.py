"""Landmark-map build CLI (pram_tpu/cli/build_map.py; reference: python -m
recognition.recmap).

Runs the full offline landmark pipeline over one scene
(recognition/recmap.py:926-1118 process_dataset): outlier removal,
clustering, per-point descriptors, VRF selection, compression, feature
export. Per-dataset hyperparameters follow the reference's process_dataset
table (min_obs 150/250, birch threshold 0.01 indoor / 0.2 outdoor,
compression radius 15-64).

KMeans and the descriptor assignment run on ``--device`` (the CUDA card by
default; ``--device cuda`` without a card raises); the rest is host numpy.
Features are an hloc h5 file (read by the port's own HDF5 reader,
``io/h5.py``) or a directory of per-image ``.npy`` dicts.

Usage:
  python -m pram_tpu_torch.cli.build_map --model M --features FEATS.h5|FEATS_DIR \
      --output OUT --n_cluster 16 [--cluster_mode xz] \
      [--cluster_method birch] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp


def main(argv=None):
    """Build the landmark map; returns each stage's milliseconds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help="triangulated COLMAP model")
    ap.add_argument("--features", required=True, help="hloc h5 features or a directory of per-image .npy features")
    ap.add_argument("--output", required=True, help="landmark output dir")
    ap.add_argument("--n_cluster", type=int, default=16)
    ap.add_argument("--cluster_mode", default="xz")
    ap.add_argument("--cluster_method", default="birch",
                    choices=["birch", "kmeans"])
    ap.add_argument("--birch_threshold", type=float, default=0.01)
    ap.add_argument("--min_obs", type=int, default=3)
    ap.add_argument("--vrf_min_obs", type=int, default=120)
    ap.add_argument("--compress_radius", type=float, default=20.0)
    ap.add_argument("--covisible_frame", type=int, default=20)
    ap.add_argument("--outlier_neighbors", type=int, default=20)
    ap.add_argument("--outlier_std", type=float, default=2.0)
    ap.add_argument("--export_descriptors", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of KMeans and the descriptor assignment")
    args = ap.parse_args(argv)

    from pram_tpu_torch.core.profiling import StageTimer
    from pram_tpu_torch.mapping.recmap import FeatureSource, RecMap

    os.makedirs(args.output, exist_ok=True)
    tag = f"n{args.n_cluster}_{args.cluster_mode}_{args.cluster_method}"
    timer = StageTimer(args.device)

    m = RecMap(args.device)
    with timer.stage("load"):
        m.load_sfm_model(args.model)
    print(f"loaded {len(m.points3D)} points, {len(m.images)} images")
    with timer.stage("outliers"):
        m.remove_statics_outlier(args.outlier_neighbors, args.outlier_std)
    print(f"after outlier removal: {len(m.points3D)} points")

    with timer.stage("clustering"):
        m.cluster(
            k=args.n_cluster,
            mode=args.cluster_mode,
            min_obs=args.min_obs,
            method=args.cluster_method,
            birch_threshold=args.birch_threshold,
            save_fn=osp.join(args.output, f"point3D_cluster_{tag}.npy"),
        )
    features = FeatureSource(args.features)
    with timer.stage("descriptors"):
        descs = m.assign_point3D_descriptors(
            features, save_fn=osp.join(args.output, "point3D_desc.npy")
        )
    with timer.stage("vrf"):
        vrf = m.create_virtual_frames(
            save_fn=osp.join(args.output, f"point3D_vrf_{tag}.npy"),
            min_obs=args.vrf_min_obs,
            covisible_frame=args.covisible_frame,
        )
    with timer.stage("compression"):
        m.compress_map_by_projection(
            vrf,
            descs,
            radius=args.compress_radius,
            covisible_frames=args.covisible_frame,
            save_dir=osp.join(args.output, f"compress_model_{args.cluster_method}"),
        )
    with timer.stage("export"):
        m.export_features_to_directory(
            args.features,
            osp.join(args.output, "feats"),
            with_descriptors=args.export_descriptors,
        )
    print(f"landmark map written to {args.output} ({timer.summary()})")
    return timer.means_ms()


if __name__ == "__main__":
    main()
