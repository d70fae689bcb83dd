"""Triangulation CLI (pram_tpu/cli/triangulate.py; reference: python -m
localization.triangulation).

Triangulates a COLMAP model against its known poses from hloc h5 features
and matches (``mapping/triangulate.py:run_triangulation``, host numpy and
sqlite; the h5 files through ``io/h5.py``).

Usage:
  python -m pram_tpu_torch.cli.triangulate --reference_model M --features F.h5 \
      --pairs pairs.txt --matches matches.h5 --output OUT
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Writes the triangulated model; returns its statistics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference_model", required=True)
    ap.add_argument("--features", required=True)
    ap.add_argument("--pairs", required=True)
    ap.add_argument("--matches", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--max_error", type=float, default=4.0)
    ap.add_argument("--min_match_score", type=float, default=None)
    args = ap.parse_args(argv)

    from pram_tpu_torch.mapping.triangulate import run_triangulation

    stats = run_triangulation(
        args.reference_model,
        args.features,
        args.pairs,
        args.matches,
        args.output,
        max_error=args.max_error,
        min_match_score=args.min_match_score,
    )
    print(
        "triangulated {num_points} points, mean track length "
        "{mean_track_length:.2f}".format(**stats)
    )
    return stats


if __name__ == "__main__":
    main()
