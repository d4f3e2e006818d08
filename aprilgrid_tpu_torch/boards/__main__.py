"""CLI: generate a Kalibr-compatible AprilGrid chart (SVG/PNG/PDF/JSON).

Equivalent of the reference's scripts/generate_aprilgrid.py CLI
(reference :1170-1206), backed by ``boards.generator``. Run as
``python -m aprilgrid_tpu_torch.boards -t t16h5 -x 4 -y 4 --out-dir charts``.
"""

import argparse
import sys

from .generator import AprilGridBoard, generate_chart


def main() -> int:
    p = argparse.ArgumentParser("Generate aprilgrid pdf/svg/png/json")
    p.add_argument(
        "-t", "--tag-family",
        choices=["t16h5", "t25h7", "t25h9", "t36h11", "t36h11b1"],
        default="t36h11",
    )
    p.add_argument("-x", type=int, default=6, help="number of tags in x")
    p.add_argument("-y", type=int, default=6, help="number of tags in y")
    p.add_argument("--marker-length-meter", type=float, default=0.088)
    p.add_argument("--tag-spacing", type=float, default=0.3)
    p.add_argument("--border-bits", type=int, default=2, choices=[1, 2])
    p.add_argument("--first-marker-id", type=int, default=0)
    p.add_argument("--page-width-meter", type=float, default=0.8)
    p.add_argument("--page-height-meter", type=float, default=0.8)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--pixels-per-mm", type=float, default=4.0)
    args = p.parse_args()

    # t36h11b1 is the T36H11 code table drawn with a one-bit border
    border = 1 if args.tag_family == "t36h11b1" else args.border_bits
    board = AprilGridBoard(
        size_x=args.x,
        size_y=args.y,
        marker_length_meter=args.marker_length_meter,
        tag_spacing=args.tag_spacing,
        border_bits=border,
        first_marker=args.first_marker_id,
        tag_family=args.tag_family,
        page_width_meter=args.page_width_meter,
        page_height_meter=args.page_height_meter,
    )
    written = generate_chart(board, args.out_dir, pixels_per_mm=args.pixels_per_mm)
    for fmt, path in written.items():
        print(f"{fmt}: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
