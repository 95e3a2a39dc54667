"""Offline re-scoring of saved predictions (no models, no images).

Counterpart of `tpupose/cli/score.py`. The reference supports this through
a commented-out call (`src/evalmodel.py:386`: re-run Evaluate3DPose_PCP on
a saved pkl); here it is a CLI of its own:

    python -m tpupose_torch.cli.score --pred preds.pkl --gt ../CatchImage/Shelf \
        --dataset Shelf --ranges 300:601
    python -m tpupose_torch.cli.score --pred preds.pkl --panoptic-root <seq_dir>
"""
from __future__ import annotations

import argparse


def _parse_ranges(specs):
    out = []
    for spec in specs:
        a, b = spec.split(":")
        out.append([int(a), int(b)])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred", required=True, help="predictions pkl")
    parser.add_argument("--gt", help="dataset root containing actorsGT.mat")
    parser.add_argument("--dataset", default="Shelf")
    parser.add_argument("--ranges", nargs="*", default=[],
                        help="eval ranges start:end")
    parser.add_argument("--panoptic-root",
                        help="Panoptic sequence dir (hdPose3d_stage1_coco19)")
    args = parser.parse_args(argv)

    if args.panoptic_root:
        from tpupose_torch.eval import evaluate_panoptic_from_pickle

        evaluate_panoptic_from_pickle(args.pred, args.panoptic_root)
        return

    from tpupose_torch.eval import evaluate_pcp_from_pickle

    ranges = _parse_ranges(args.ranges)
    res = evaluate_pcp_from_pickle(ranges, args.pred, args.gt, args.dataset)
    print(res["table"])
    print(f"Average PCP: {res['average'] * 100:.2f}")


if __name__ == "__main__":
    main()
