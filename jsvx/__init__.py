"""jsvx — a JAX JSV (MPEG-1 I/P) video decode framework for GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
``anton-v-bilan/mpeg1video-decoder-webgl`` browser player ("Leon"):

* ``jsvx.coding``    — MPEG-1 VLC tables, quant matrices, scan orders.
* ``jsvx.bitstream`` — container/sequence/picture/slice/macroblock parsing,
  sparse byte-range buffering, streaming bit reader (Python + C++ backends).
* ``jsvx.kernels``   — the device compute path: dequant + 8x8 IDCT +
  half-pel motion compensation + color conversion (XLA, and a fused
  Pallas kernel through Triton for GPUs).
* ``jsvx.pipeline``  — per-GOP recurrent decode (lax.scan carry of reference
  planes), decode-ahead scheduling.
* ``jsvx.shard``     — multi-device decode: slice-row sharding with halo
  exchange, GOP-parallel data sharding over a jax.sharding.Mesh.
* ``jsvx.runtime``   — byte sources (file/HTTP range), multi-host launch,
  the persistent compile cache.
* ``jsvx.api``       — Decoder / Player with the HTML5-video-like event
  surface of the reference player.
* ``jsvx.tools``     — JSV fixture encoder, float64 oracle decoder, PSNR.

The reference is a JavaScript+WebGL program; nothing here is a port.  The
serial bitstream front-end becomes a batch token-decode stage producing dense
per-frame tensors, and the four WebGL fragment-shader stages become dense
plane math (or one fused kernel per plane) over batched macroblock planes.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level conveniences (avoid importing jax at package import)."""
    if name in ("Player", "Decoder", "PlayerConfig", "MediaError"):
        from . import api

        return getattr(api, name)
    if name == "JaxStreamDecoder":
        from .pipeline.stream import JaxStreamDecoder

        return JaxStreamDecoder
    if name == "transcode":
        from .pipeline.transcode import transcode

        return transcode
    if name in ("encode_frames", "decode_stream_oracle"):
        from . import tools

        return getattr(tools, name)
    raise AttributeError(f"module 'jsvx' has no attribute {name!r}")
