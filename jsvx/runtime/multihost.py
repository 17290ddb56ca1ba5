"""Multi-host decoding: a GOP manifest across hosts, devices within each.

BASELINE.md config 5: GOPs distributed across N >= 2 hosts with frames /
slice-rows across each host's chips.  GOPs are closed decode units keyed
by the container's seek index, so the cross-host protocol degenerates to
a *work manifest* — no tensor traffic crosses hosts, only byte ranges and
completion records.  This module provides:

* :func:`initialize` — ``jax.distributed`` bootstrap for a cluster;
* :class:`GopManifest` — the manifest: GOP byte spans from the key map
  (or a start-code scan), static round-robin assignment per process, and
  durable completion tracking (JSON journal) giving GOP-granular
  checkpoint/resume — the batch analog of the reference's key-map
  restartability (``decoders/jsv.js:282-350``; SURVEY.md section 5).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..bitstream.bitio import BitReader
from ..bitstream.container import (StartCodeIndex, parse_container_header)
from ..coding import tables as T


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               num_local_devices: int | None = None) -> tuple[int, int]:
    """Bring up jax.distributed; returns (process_index, process_count).

    With no arguments, uses the JAX defaults (env-configured clusters);
    single-process when no cluster env is present.  On the CPU backend
    (tests / virtual pods) the gloo collectives layer is enabled first so
    the global device mesh genuinely spans processes — the same
    controller-per-host shape as a real cluster, with gloo standing in
    for the interconnect.  ``num_local_devices`` forces the per-process device
    count (CPU backend only; call before any backend use).
    """
    import jax

    if coordinator_address is not None:
        plats = (jax.config.jax_platforms or "")
        if "cpu" in str(plats).split(","):
            jax.config.update("jax_cpu_collectives_implementation",
                              "gloo")
        if num_local_devices is not None:
            try:
                jax.config.update("jax_num_cpu_devices",
                                  num_local_devices)
            except Exception:
                pass
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_index(), jax.process_count()


@dataclass
class GopSpan:
    index: int
    byte_start: int
    byte_end: int           # exclusive
    time_s: float = 0.0


@dataclass
class GopManifest:
    spans: list = field(default_factory=list)
    journal_path: str | None = None
    _done: set = field(default_factory=set)

    # ------------------------------------------------------------------
    @classmethod
    def from_stream(cls, data: bytes,
                    journal_path: str | None = None) -> "GopManifest":
        """Build from the container key map, else scan for sequence
        headers (every GOP is preceded by one in JSV streams)."""
        r = BitReader(bytes(data))
        meta = parse_container_header(r)
        if meta.key_map is not None and meta.key_map.count > 0:
            offsets = [int(o) for o in meta.key_map.offsets]
        else:
            idx = StartCodeIndex.scan(bytes(data))
            offsets = [int(off) for off, code in idx.entries
                       if code == T.START_SEQUENCE]
        spans = []
        for i, off in enumerate(offsets):
            end = offsets[i + 1] if i + 1 < len(offsets) else len(data)
            spans.append(GopSpan(index=i, byte_start=off, byte_end=end))
        m = cls(spans=spans, journal_path=journal_path)
        m._load_journal()
        return m

    # ------------------------------------------------------------------
    # assignment

    def assigned(self, process_id: int, process_count: int) -> list:
        """Static round-robin shard of GOPs for one host."""
        return [s for s in self.spans if s.index % process_count
                == process_id]

    def pending(self, process_id: int = 0, process_count: int = 1) -> list:
        return [s for s in self.assigned(process_id, process_count)
                if s.index not in self._done]

    # ------------------------------------------------------------------
    # durable completion journal (checkpoint/resume)

    def _load_journal(self) -> None:
        if self.journal_path and os.path.exists(self.journal_path):
            with open(self.journal_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._done.add(json.loads(line)["gop"])

    def mark_done(self, gop_index: int, **info) -> None:
        self._done.add(gop_index)
        if self.journal_path:
            with open(self.journal_path, "a") as f:
                f.write(json.dumps({"gop": gop_index, **info}) + "\n")

    def is_done(self, gop_index: int) -> bool:
        return gop_index in self._done

    @property
    def n_done(self) -> int:
        return len(self._done)

    @property
    def complete(self) -> bool:
        return len(self._done) >= len(self.spans)
