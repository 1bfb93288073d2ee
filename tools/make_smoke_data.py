"""Encode the inputs of ``chip_smoke.py`` into ``tests/data/smoke/``.

A host that runs the smoke need not have libvorbisenc, so its streams are
encoded once, here, from fixed seeds and settings, and committed with a
manifest that names each stream's settings and sha256. The smoke reads
the manifest and refuses a file whose hash differs.

Streams (synthesized music-like signals, ``testing/encode.make_signal``):

- ``corpus_*``: 8 stereo tracks, 44.1 kHz, quality 0.5, 120-240 s each
  (24 min in all): the full-length-track corpus.
- ``surround``: one 5.1 stream, 48 kHz, quality 0.5, 60 s (Residue2 and
  coupling over six channels).
- ``chain_a``/``chain_b``: two stereo streams, 44.1 kHz, quality 0.4,
  serials 1 and 2, which the smoke chains into one physical stream.

Run: ``python tools/make_smoke_data.py`` (needs libvorbisenc).
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "data" / "smoke"

#: (name, channels, seconds, rate, quality, seed, serial)
SPECS = [
    *(
        (f"corpus_{k}", 2, 120.0 + round(k * 120.0 / 7), 44100, 0.5, k, 1)
        for k in range(8)
    ),
    ("surround", 6, 60.0, 48000, 0.5, 100, 1),
    ("chain_a", 2, 20.0, 44100, 0.4, 200, 1),
    ("chain_b", 2, 25.0, 44100, 0.4, 201, 2),
]


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    OUT.mkdir(parents=True, exist_ok=True)
    manifest = []
    for name, channels, seconds, rate, quality, seed, serial in SPECS:
        data = encode_vorbis(
            make_signal(channels, seconds, rate=rate, kind="music", seed=seed),
            rate=rate,
            quality=quality,
            serial=serial,
        )
        (OUT / f"{name}.ogg").write_bytes(data)
        manifest.append(
            {
                "name": name,
                "channels": channels,
                "seconds": seconds,
                "rate": rate,
                "quality": quality,
                "seed": seed,
                "serial": serial,
                "bytes": len(data),
                "sha256": hashlib.sha256(data).hexdigest(),
            }
        )
        print(f"{name}: {len(data)} bytes")
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")


if __name__ == "__main__":
    main()
