"""The committed streams of ``tests/data/smoke`` (made by
``tools/make_smoke_data.py``): inputs for hosts without libvorbisenc,
such as the GPU host that runs ``chip_smoke.py``. Read from a checkout of
the repository, where they sit beside the package."""

from __future__ import annotations

import hashlib
import json
import pathlib

DATA = pathlib.Path(__file__).resolve().parents[2] / "tests" / "data" / "smoke"


def load_streams() -> dict:
    """name -> (manifest entry, path, bytes); raises on a file whose hash
    differs from its manifest entry."""
    manifest = json.loads((DATA / "manifest.json").read_text())
    out = {}
    for m in manifest:
        path = DATA / f"{m['name']}.ogg"
        data = path.read_bytes()
        if hashlib.sha256(data).hexdigest() != m["sha256"]:
            raise RuntimeError(f"{path} does not match its manifest hash")
        out[m["name"]] = (m, path, data)
    return out


def chain_members() -> list[bytes]:
    """The two short stereo streams (20 s and 25 s): the smallest
    committed inputs."""
    streams = load_streams()
    return [streams[n][2] for n in ("chain_a", "chain_b")]
