"""Debug overlay rendering — the observability surface.

The reference's observability is rerun.io streams of every intermediate
(examples/demo.rs:101-120, examples/develop.rs:147-173). rerun is not
available here, so the equivalent is a PIL overlay dumper drawing the
same layers: refined saddles (with orientation ticks), decoded tag
corners with per-tag deterministic colors and "t{id}" labels, and decode
sample points.

Frames are numpy arrays; a torch tensor (which ``TagDetector.detect`` also
takes) is brought to the host first. Saddles are
``detector.Saddle`` records (``.p``, ``.theta``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _tag_color(tag_id: int) -> tuple[int, int, int]:
    """Deterministic per-tag color (reference seeds ChaCha8 with the id,
    examples/demo.rs:85-89; any stable id->color map serves the purpose)."""
    rng = np.random.default_rng(np.uint64(tag_id) * np.uint64(2654435761))
    return tuple(int(v) for v in rng.integers(64, 255, 3))


def render_overlay(
    img: np.ndarray,
    tags: dict[int, list[tuple[float, float]]] | None = None,
    saddles=None,
    decode_points: dict[int, list[tuple[float, float]]] | None = None,
    corner_radius: int = 3,
):
    """Return an RGB uint8 image with detection layers drawn on top."""
    from PIL import Image, ImageDraw

    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    if img.ndim == 2:
        if img.dtype == np.uint16:
            img = (img // 257).astype(np.uint8)
        base = np.stack([img] * 3, axis=-1)
    else:
        base = img[..., :3].astype(np.uint8)
    im = Image.fromarray(base)
    draw = ImageDraw.Draw(im)

    if saddles:
        for s in saddles:
            x, y = s.p
            t = np.radians(s.theta)
            dx, dy = 6 * np.cos(t), 6 * np.sin(t)
            draw.line([x - dx, y - dy, x + dx, y + dy], fill=(255, 220, 0), width=1)
            draw.ellipse(
                [x - 1.5, y - 1.5, x + 1.5, y + 1.5], outline=(255, 160, 0)
            )

    if decode_points:
        for tag_id, pts in decode_points.items():
            color = _tag_color(tag_id)
            for (x, y) in pts:
                draw.ellipse([x - 1, y - 1, x + 1, y + 1], fill=color)

    if tags:
        for tag_id, corners in tags.items():
            color = _tag_color(tag_id)
            poly = [(float(x), float(y)) for (x, y) in corners]
            draw.polygon(poly, outline=color)
            for i, (x, y) in enumerate(poly):
                r = corner_radius
                draw.ellipse([x - r, y - r, x + r, y + r], outline=color)
                if i == 0:
                    draw.text((x + 4, y - 10), f"t{tag_id}", fill=color)
    return np.asarray(im)


def dump_overlay(path: str | Path, img: np.ndarray, **layers) -> Path:
    """Render and save an overlay PNG; returns the path."""
    from PIL import Image

    out = render_overlay(img, **layers)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(out).save(path)
    return path


def write_timeline_html(out_dir: str | Path, entries: list[dict]) -> Path:
    """Self-contained interactive timeline viewer — the stand-in for the
    reference demo's rerun.io stream (examples/demo.rs:101-120): a
    scrubber/play timeline over the frames with client-side vector
    layers (tag quads + ids, decode sample points, saddles) toggleable
    per entity class and per-frame stats, rendered on a canvas over the
    raw frame. Open ``timeline.html`` in any browser; no server needed.

    ``entries``: per frame {"image": raw png filename (relative),
    "timeline_ns", "detect_ms", "tags": {id: [[x,y]x4]},
    "decode_points": {id: [[x,y]...]}, "saddles": [[x,y,theta]...]}.
    """
    import json as _json

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    data = _json.dumps(entries)
    html = """<!doctype html>
<meta charset="utf-8"><title>aprilgrid-tpu timeline</title>
<style>
 body{background:#111;color:#ddd;font:13px monospace;margin:12px}
 #bar{margin:8px 0}#bar *{vertical-align:middle}
 canvas{border:1px solid #333;max-width:100%}
 label{margin-right:12px}input[type=range]{width:420px}
 #stats{color:#8fc}
</style>
<div id="bar">
 <button id="play">&#9654;</button>
 <input type="range" id="scrub" min="0" value="0">
 <span id="name"></span> <span id="stats"></span><br>
 <label><input type="checkbox" id="Ltags" checked>tag quads</label>
 <label><input type="checkbox" id="Ldec" checked>decode points</label>
 <label><input type="checkbox" id="Lsad">saddles</label>
</div>
<canvas id="cv"></canvas>
<script>
const F=__DATA__;let i=0,playing=false;
const cv=document.getElementById('cv'),cx=cv.getContext('2d');
const scrub=document.getElementById('scrub');scrub.max=F.length-1;
const imgs=F.map(f=>{const im=new Image();im.src=f.image;return im});
function color(id){let h=(id*2654435761)>>>0;return `hsl(${h%360},85%,60%)`}
function draw(){
 const f=F[i],im=imgs[i];
 if(!im.complete){im.onload=draw;return}
 cv.width=im.naturalWidth;cv.height=im.naturalHeight;
 cx.drawImage(im,0,0);
 if(document.getElementById('Lsad').checked&&f.saddles)
  for(const[x,y,t]of f.saddles){const r=t*Math.PI/180,dx=6*Math.cos(r),dy=6*Math.sin(r);
   cx.strokeStyle='#fc0';cx.beginPath();cx.moveTo(x-dx,y-dy);cx.lineTo(x+dx,y+dy);cx.stroke()}
 if(document.getElementById('Ldec').checked&&f.decode_points)
  for(const id in f.decode_points){cx.fillStyle=color(+id);
   for(const[x,y]of f.decode_points[id])cx.fillRect(x-1,y-1,2,2)}
 if(document.getElementById('Ltags').checked&&f.tags)
  for(const id in f.tags){const c=f.tags[id];cx.strokeStyle=cx.fillStyle=color(+id);
   cx.beginPath();cx.moveTo(c[0][0],c[0][1]);
   for(let k=1;k<5;k++)cx.lineTo(c[k%4][0],c[k%4][1]);cx.stroke();
   cx.fillText('t'+id,c[0][0]+4,c[0][1]-4)}
 document.getElementById('name').textContent=f.image;
 document.getElementById('stats').textContent=
  `#${i} t=${(f.timeline_ns/1e9).toFixed(3)}s  tags=${Object.keys(f.tags||{}).length}  detect=${f.detect_ms}ms`;
 scrub.value=i;
}
scrub.oninput=()=>{i=+scrub.value;draw()};
document.getElementById('play').onclick=()=>{playing=!playing;
 document.getElementById('play').innerHTML=playing?'&#9208;':'&#9654;';
 if(playing)step()};
function step(){if(!playing)return;i=(i+1)%F.length;draw();setTimeout(step,500)}
['Ltags','Ldec','Lsad'].forEach(id=>document.getElementById(id).onchange=draw);
draw();
</script>"""
    path = out_dir / "timeline.html"
    path.write_text(html.replace("__DATA__", data))
    return path
