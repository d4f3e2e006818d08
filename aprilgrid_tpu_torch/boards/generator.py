"""Kalibr-compatible AprilGrid chart generation.

Port of the reference's standalone board generator
(scripts/generate_aprilgrid.py): a (2x+1) x (2y+1) checkerboard of
spacing squares and AprilTags laid out row-major from the bottom-left
(reference :1114-1167), each tag drawn as a black marker square with its
code bits opened as white cells row-major inside the border
(gen_square_tag, reference :1066-1112). Output formats: SVG (hand-rolled
XML — no svgwrite dependency), PNG (PIL raster), true-scale VECTOR PDF
(hand-rolled content stream — the reference goes SVG->PDF via cairosvg,
:1022-1023), and the Kalibr-style JSON config (reference :967-975).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from ..families import get_family


@dataclasses.dataclass
class AprilGridBoard:
    """Board geometry (reference BaseAprilGrid, :952-975)."""

    size_x: int = 6
    size_y: int = 6
    marker_length_meter: float = 0.088
    tag_spacing: float = 0.3
    border_bits: int = 2
    first_marker: int = 0
    tag_family: str = "t36h11"
    page_width_meter: float = 0.8
    page_height_meter: float = 0.8

    def file_name(self) -> str:
        return (
            f"{self.tag_family}_{self.size_x}x{self.size_y}"
            f"_start_id_{self.first_marker}"
        )

    def to_config(self) -> dict:
        return {
            "tag_size_meter": self.marker_length_meter,
            "tag_spacing": self.tag_spacing,
            "tag_rows": self.size_y,
            "tag_cols": self.size_x,
            "first_id": self.first_marker,
        }


def _board_rects(board: AprilGridBoard) -> list[tuple[float, float, float, float, str]]:
    """All rectangles of the chart as (x, y, w, h, color) in mm.

    Mirrors the reference layout math (add_patterns_on_svg, :1118-1167):
    rows walk from the page bottom upward, columns left to right;
    even/even cells are spacing squares, odd-row cells are tags.
    """
    spec = get_family(board.tag_family)
    nbits = spec.edge * spec.edge
    codes = [
        format(int(c), f"0{nbits}b")
        for c in spec.codes[board.first_marker :]
    ]

    page_w = board.page_width_meter * 1000.0
    page_h = board.page_height_meter * 1000.0
    small = board.marker_length_meter * board.tag_spacing * 1000.0
    marker = board.marker_length_meter * 1000.0

    shift_x = (page_w - board.size_x * (marker + small) - small) / 2.0
    shift_y = (page_h - board.size_y * (marker + small) - small) / 2.0

    rects: list[tuple[float, float, float, float, str]] = [
        (0.0, 0.0, page_w, page_h, "white")
    ]

    def tag_rects(x, y, sq, code, border_bits):
        out = [(x, y, sq, sq, "black")]
        if code:
            bits = spec.edge
            block = bits + 2 * border_bits
            cell = sq / block
            count = 0
            for r in range(border_bits, bits + border_bits):
                for c in range(border_bits, bits + border_bits):
                    if code[count] == "1":
                        out.append((x + c * cell, y + r * cell, cell, cell, "white"))
                    count += 1
        return out

    for row in range(board.size_y * 2 + 1):
        start_y = page_h - shift_y
        start_y -= ((row + 2) // 2) * small
        start_y -= ((row + 1) // 2) * marker
        for col in range(board.size_x * 2 + 1):
            start_x = shift_x
            start_x += (col + 1) // 2 * small
            start_x += col // 2 * marker
            if (row + col) % 2 != 0:
                continue
            if row % 2 == 0:
                rects.append((start_x, start_y, small, small, "black"))
            else:
                code = codes.pop(0)
                rects.extend(
                    tag_rects(start_x, start_y, marker, code, board.border_bits)
                )
    return rects


def svg_string(board: AprilGridBoard) -> str:
    page_w = board.page_width_meter * 1000.0
    page_h = board.page_height_meter * 1000.0
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{page_w}mm" '
        f'height="{page_h}mm" viewBox="0 0 {page_w} {page_h}">'
    ]
    for (x, y, w, h, color) in _board_rects(board):
        parts.append(
            f'<rect x="{x:.6f}" y="{y:.6f}" width="{w:.6f}" '
            f'height="{h:.6f}" fill="{color}"/>'
        )
    parts.append("</svg>")
    return "\n".join(parts)


def render_png(board: AprilGridBoard, pixels_per_mm: float = 4.0) -> np.ndarray:
    """Rasterize the chart to a grayscale uint8 image."""
    from PIL import Image, ImageDraw

    page_w = board.page_width_meter * 1000.0
    page_h = board.page_height_meter * 1000.0
    wpx = int(round(page_w * pixels_per_mm))
    hpx = int(round(page_h * pixels_per_mm))
    img = Image.new("L", (wpx, hpx), 255)
    draw = ImageDraw.Draw(img)
    for (x, y, w, h, color) in _board_rects(board):
        v = 0 if color == "black" else 255
        draw.rectangle(
            [
                round(x * pixels_per_mm),
                round(y * pixels_per_mm),
                round((x + w) * pixels_per_mm) - 1,
                round((y + h) * pixels_per_mm) - 1,
            ],
            fill=v,
        )
    return np.asarray(img, dtype=np.uint8)


_MM_TO_PT = 72.0 / 25.4  # PDF user space: 1 pt = 1/72 in


def pdf_bytes(board: AprilGridBoard) -> bytes:
    """True-scale VECTOR PDF of the chart (reference: cairosvg SVG->PDF,
    scripts/generate_aprilgrid.py:1022-1023 — printed charts must be
    dimensionally exact because calibration measures against
    marker_length_meter).

    The chart is nothing but axis-aligned filled rectangles, so the PDF
    is hand-rolled: one page whose MediaBox is exactly
    page_{width,height}_meter (in points), a content stream that sets a
    mm->pt CTM and paints `_board_rects` in painter's order (white page,
    black squares, white bit cells). A printed marker square measures
    exactly marker_length_meter. No rasterization anywhere."""
    page_w = board.page_width_meter * 1000.0
    page_h = board.page_height_meter * 1000.0
    ops = [f"{_MM_TO_PT:.8f} 0 0 {_MM_TO_PT:.8f} 0 0 cm"]
    for (x, y, w, h, color) in _board_rects(board):
        gray = "0" if color == "black" else "1"
        # SVG y grows downward from the top edge; PDF y grows upward
        ops.append(
            f"{gray} g {x:.6f} {page_h - y - h:.6f} "
            f"{w:.6f} {h:.6f} re f"
        )
    content = "\n".join(ops).encode("ascii")

    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (
            f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 "
            f"{page_w * _MM_TO_PT:.6f} {page_h * _MM_TO_PT:.6f}] "
            f"/Contents 4 0 R /Resources << >> >>"
        ).encode("ascii"),
        b"<< /Length %d >>\nstream\n%s\nendstream"
        % (len(content), content),
    ]
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objs, start=1):
        offsets.append(len(out))
        out += b"%d 0 obj\n%s\nendobj\n" % (i, body)
    xref_at = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    for off in offsets:
        out += b"%010d 00000 n \n" % off
    out += (
        b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
        % (len(objs) + 1, xref_at)
    )
    return bytes(out)


def generate_chart(
    board: AprilGridBoard,
    out_dir: str | Path = ".",
    name: str | None = None,
    formats: tuple[str, ...] = ("svg", "png", "pdf", "json"),
    pixels_per_mm: float = 4.0,
) -> dict[str, Path]:
    """Write the chart in the requested formats; returns {format: path}."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    base = out_dir / (name or board.file_name())
    written: dict[str, Path] = {}
    if "svg" in formats:
        p = base.with_suffix(".svg")
        p.write_text(svg_string(board))
        written["svg"] = p
    if "png" in formats:
        arr = render_png(board, pixels_per_mm)
        p = base.with_suffix(".png")
        Image.fromarray(arr).save(p)
        written["png"] = p
    if "pdf" in formats:
        # true-scale vector PDF: a raster PDF loses print-scale fidelity
        p = base.with_suffix(".pdf")
        p.write_bytes(pdf_bytes(board))
        written["pdf"] = p
    if "json" in formats:
        p = base.with_suffix(".json")
        p.write_text(json.dumps(board.to_config(), indent=2))
        written["json"] = p
    return written
