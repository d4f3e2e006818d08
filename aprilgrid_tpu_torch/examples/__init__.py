"""Runnable examples of the port, the counterparts of the JAX repo's
``examples/`` scripts (themselves the reference's examples/demo.rs and
examples/develop.rs):

* ``demo`` — detect over a directory of frames, write per-frame overlays,
  raw copies, a JSONL manifest and the interactive ``timeline.html``;
* ``develop`` — the pipeline's intermediates for one image: refined
  saddles, board quads, decoded tags, one overlay;
* ``live`` — detect over a directory in a loop and serve the overlays as
  an MJPEG stream (``live.LiveStream``).

Each runs as ``python3 -m aprilgrid_tpu_torch.examples.<name>`` and exposes
``main(argv=None) -> int``. They run on the card (``--device cuda``, the
default) or on the plain PyTorch versions with ``--device cpu``; without a
card ``--device cuda`` raises, as ``TagDetector`` does.
"""
