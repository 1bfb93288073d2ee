"""Smoke test of the production decode path on a GPU.

    python chip_smoke.py          # phases a-d on one card
    python chip_smoke.py --four   # multi-device paths on four cards

One process drives the card(s). The script refuses to run unless JAX's
first device is a GPU: there is no CPU fallback.

Phases (one card), all through the public entry points, on the committed
streams of ``tests/data/smoke`` (``vorbispizza_tpu/testing/smoke_data.py``,
made by ``tools/make_smoke_data.py``):

a. an 8-track stereo corpus (44.1 kHz, q0.5, 24 min) through
   ``decode_corpus`` in all three output tiers: s16 over the dpack wire,
   f32, and device-resident f32;
b. one 5.1 stream (48 kHz, 60 s) through the same tiers;
c. two chained stereo streams read through
   ``VorbisReader(..., accelerated=True)``: whole reads and 32 seeks;
d. checks on every stream of a-c: f32 max-abs against the float64
   anchor within ``F32_BUDGET``, s16 within ``S16_BUDGET_LSB`` of the
   libvorbisfile oracle (or of the quantized anchor where that library is
   absent), dpack s16 bit-identical to raw s16 in both wire families
   (width-only and rice), and the same call made twice compared bitwise
   (printed, not gated: see README "Numerics").

``--four`` runs only ``decode_corpus_sharded`` over a 4-device stream
mesh, ``decode_corpus(devices=...)`` round-robin over four devices, and
the ('stream', 'frame') mesh step, each against the same decode on
device 0, on four short stereo streams (the chain members, twice).

Every line but the last is a log line. The last line of stdout is one
JSON object, printed only when every phase passed:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time

import numpy as np

#: max-abs f32 PCM error against the float64 anchor (decoder.py): the
#: repo's accuracy budget for the device path
F32_BUDGET = 1e-6
#: s16 error against the oracle or the quantized anchor: one rounding
#: decision may flip where the f32 values straddle a half-LSB boundary
S16_BUDGET_LSB = 1
#: seeks per chained member in phase c (two members: 32 seeks)
SEEKS_PER_STREAM = 16
SEEK_READ = 1024
#: concurrent compiles in the warm-up: XLA compiles a fused program in
#: tens of seconds on one core, and a cold run has ~40 of them
WARM_WORKERS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


# -- references -----------------------------------------------------------------


def anchor_pcm(data: bytes) -> np.ndarray:
    """The float64 scalar decoder's PCM (clipped float32, planar)."""
    from vorbispizza_tpu.reader import VorbisReader

    r = VorbisReader(io.BytesIO(data))
    r.initialize()
    return r.read_all(planar=True)


def quantize(pcm: np.ndarray) -> np.ndarray:
    """libvorbisfile ``ov_read`` quantization of float PCM to int16."""
    return np.clip(
        np.rint(pcm.astype(np.float64) * 32768.0), -32768, 32767
    ).astype(np.int16)


def oracle_available() -> bool:
    from vorbispizza_tpu.testing import oracle

    try:
        oracle._load()
    except OSError:
        return False
    return True


def s16_reference(path, anchor: np.ndarray, use_oracle: bool) -> np.ndarray:
    """s16 the device path is held to: libvorbisfile's output where that
    library loads, else the quantized anchor."""
    if not use_oracle:
        return quantize(anchor)
    from vorbispizza_tpu.testing.oracle import OracleDecoder

    dec = OracleDecoder(str(path))
    try:
        return quantize(dec.read_float())
    finally:
        dec.close()


# -- comparisons ------------------------------------------------------------------


def max_abs(got: list, want: list) -> float:
    """Largest |got - want| over streams; inf on a shape mismatch."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        g = np.asarray(g)
        if g.shape != w.shape:
            return float("inf")
        if g.size:
            d = np.abs(g.astype(np.float64) - w.astype(np.float64)).max()
            worst = max(worst, float(d))
    return worst


def bitwise(got: list, want: list) -> bool:
    return all(
        np.asarray(g).shape == w.shape and np.array_equal(np.asarray(g), w)
        for g, w in zip(got, want, strict=True)
    )


def repeat_note(first: list, second: list) -> str:
    if bitwise(first, second):
        return "bit-identical"
    return f"DIFFER max {max_abs(first, second):.3e}"


def peak_bytes(dev) -> int | None:
    stats = dev.memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


# -- phases -----------------------------------------------------------------------


@contextlib.contextmanager
def wire_config(wire: str | None = None, rice: str | None = None):
    """Set ``config.s16_wire``/``s16_rice`` (process-wide) where given,
    restoring both after."""
    from vorbispizza_tpu.config import VorbisConfig

    cfg = VorbisConfig.default
    saved = cfg.s16_wire, cfg.s16_rice
    if wire is not None:
        cfg.s16_wire = wire
    if rice is not None:
        cfg.s16_rice = rice
    try:
        yield
    finally:
        cfg.s16_wire, cfg.s16_rice = saved


def _decode(
    sources, tier: str, wire: str | None = None, rice: str | None = None, **kw
):
    """(host PCM list, wall seconds) of one ``decode_corpus`` call with
    ``config.s16_wire``/``s16_rice`` set to ``wire``/``rice`` where given
    (``kw`` passes through); the device tier is waited for inside the
    timed region and pulled after."""
    import jax

    from vorbispizza_tpu.decoder import CLIP_MAX
    from vorbispizza_tpu.models.corpus import decode_corpus

    with wire_config(wire, rice):
        t0 = time.perf_counter()
        outs = decode_corpus(sources, output=tier, **kw)
        if tier == "device":
            jax.block_until_ready(outs)
        wall = time.perf_counter() - t0
    if tier == "device":
        # the device tier is unclipped; clip like the host f32 tier
        outs = [np.clip(np.asarray(o), -CLIP_MAX, CLIP_MAX) for o in outs]
    return outs, wall


def check_corpus(label, sources, anchors, s16_refs, *, f32_budget=F32_BUDGET):
    """decode_corpus on ``sources`` in every output tier, each called
    twice, plus s16 over the raw wire and over the dpack wire in both of
    its families (width-only and rice, forced); checked against the
    anchor and the s16 reference, and each dpack family bitwise against
    raw. Logs each result as it lands and returns them as a dict; raises
    PhaseFailed past a budget."""
    res = {}

    def note(key, value):
        res[key] = value
        log(f"  {label} {key}={value}")

    runs = {}
    for tier in ("s16", "f32", "device"):
        first, first_s = _decode(sources, tier)
        second, wall_s = _decode(sources, tier)
        runs[tier] = first
        note(f"{tier}_first_call_s", round(first_s, 3))
        note(f"{tier}_wall_s", round(wall_s, 3))
        note(f"{tier}_repeat", repeat_note(first, second))
    raw, raw_s = _decode(sources, "s16", wire="raw")
    note("s16_raw_first_call_s", round(raw_s, 3))
    families = {}
    for family, rice in (("width", "off"), ("rice", "on")):
        families[family], fam_s = _decode(sources, "s16", rice=rice)
        note(f"s16_{family}_wall_s", round(fam_s, 3))

    note("f32_max_abs", max_abs(runs["f32"], anchors))
    note("device_max_abs", max_abs(runs["device"], anchors))
    note("device_eq_f32", bitwise(runs["device"], runs["f32"]))
    note("s16_max_lsb", max_abs(runs["s16"], s16_refs))
    for family, got in families.items():
        note(f"dpack_{family}_eq_raw", bitwise(got, raw))
        if not res[f"dpack_{family}_eq_raw"]:
            note(f"dpack_{family}_raw_max_lsb", max_abs(got, raw))

    errors = []
    for k in ("f32_max_abs", "device_max_abs"):
        if not res[k] <= f32_budget:
            errors.append(f"{k} {res[k]:.3e} > {f32_budget:.0e}")
    if not res["s16_max_lsb"] <= S16_BUDGET_LSB:
        errors.append(f"s16 {res['s16_max_lsb']} LSB > {S16_BUDGET_LSB}")
    for family in families:
        if not res[f"dpack_{family}_eq_raw"]:
            errors.append(f"dpack s16 ({family}) differs from raw s16")
    if errors:
        raise PhaseFailed(f"{label}: " + "; ".join(errors))
    return res


def _open_chained(chained: bytes, accelerated: bool):
    from vorbispizza_tpu.reader import VorbisReader

    r = VorbisReader(io.BytesIO(chained), accelerated=accelerated)
    r.initialize()
    while r.find_next_stream():
        pass
    return r


def _read_members(reader) -> list:
    out = []
    for s in range(reader.streams_count):
        reader.switch_streams(s)
        out.append(reader.read_all(planar=True))
    return out


def check_chained(label, chained: bytes, *, seed=0, f32_budget=F32_BUDGET):
    """Chained stream through VorbisReader(accelerated=True): every
    member read whole, then SEEKS_PER_STREAM seeks + reads per member,
    each against the scalar reader; a second accelerated reader repeats
    the whole reads for the bitwise check."""
    t0 = time.perf_counter()
    acc = _open_chained(chained, True)
    ref = _open_chained(chained, False)
    if acc.streams_count != ref.streams_count or acc.streams_count < 2:
        raise PhaseFailed(
            f"{label}: {acc.streams_count} accelerated vs "
            f"{ref.streams_count} scalar streams (want >= 2)"
        )
    whole = _read_members(acc)
    want_whole = _read_members(ref)
    first_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed)
    seek_got, seek_want = [], []
    t0 = time.perf_counter()
    for s in range(acc.streams_count):
        acc.switch_streams(s)
        ref.switch_streams(s)
        hi = max(acc.total_samples - SEEK_READ, 1)
        for p in rng.integers(0, hi, size=SEEKS_PER_STREAM):
            acc.seek_to(int(p))
            seek_got.append(acc.read_samples(SEEK_READ, planar=True))
            ref.seek_to(int(p))
            seek_want.append(ref.read_samples(SEEK_READ, planar=True))
    seek_s = time.perf_counter() - t0

    res = {
        "streams": acc.streams_count,
        "first_read_s": round(first_s, 3),
        "seeks": len(seek_got),
        "seek_read_wall_s": round(seek_s, 4),
        "f32_max_abs": max_abs(whole, want_whole),
        "seek_max_abs": max_abs(seek_got, seek_want),
        "repeat": repeat_note(whole, _read_members(_open_chained(chained, True))),
    }
    for k, v in res.items():
        log(f"  {label} {k}={v}")
    errors = [
        f"{k} {res[k]:.3e} > {f32_budget:.0e}"
        for k in ("f32_max_abs", "seek_max_abs")
        if not res[k] <= f32_budget
    ]
    if errors:
        raise PhaseFailed(f"{label}: " + "; ".join(errors))
    return res


def references(items, use_oracle: bool):
    """(anchors, s16 references, seconds) for [(path, bytes)]."""
    t0 = time.perf_counter()
    anchors = [anchor_pcm(data) for _, data in items]
    s16_refs = [
        s16_reference(path, a, use_oracle) for (path, _), a in zip(items, anchors)
    ]
    return anchors, s16_refs, time.perf_counter() - t0


def warm_up(
    phases, chained: bytes | None = None, workers: int = WARM_WORKERS
) -> float:
    """Compile the programs the phases will run, concurrently.

    ``phases``: [(label, sources)]. Each phase's sources are split into
    the chunks ``decode_corpus`` will dispatch (``plan_chunks``), and each
    chunk is decoded once per wire and tier on a thread pool: s16 over the
    dpack wire as configured and f32 (which the device tier shares), then
    s16 over the raw wire, then over the forced rice wire, one round each
    because the wire is process-wide config. The chained stream is read
    once. Logs each decode's wall (its compile and first run, beside the
    others) tagged with phase, chunk and wire/tier; returns the total."""
    from concurrent.futures import ThreadPoolExecutor

    from vorbispizza_tpu.models.corpus import decode_corpus, plan_chunks

    def timed(tag, fn, *args, **kw):
        t0 = time.perf_counter()
        fn(*args, **kw)
        log(f"  warm {tag}: {time.perf_counter() - t0:.1f} s")

    jobs = []
    for label, srcs in phases:
        chunks = plan_chunks(srcs)
        for k, chunk in enumerate(chunks):
            tag = f"{label} chunk {k + 1}/{len(chunks)}"
            jobs.append((tag, [srcs[i] for i in chunk]))
    # (name of the s16 wire, s16_wire, s16_rice, tiers); f32 also serves
    # the device tier
    rounds = [
        ("dpack", None, None, ("s16", "f32")),
        ("raw", "raw", None, ("s16",)),
        ("rice", None, "on", ("s16",)),
    ]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        if chained is not None:
            reader = pool.submit(
                timed,
                "chained reader",
                lambda: _read_members(_open_chained(chained, True)),
            )
        for name, wire, rice, tiers in rounds:
            with wire_config(wire, rice):
                futs = [
                    pool.submit(
                        timed,
                        f"{tag} {name if tier == 's16' else tier}",
                        decode_corpus,
                        srcs,
                        output=tier,
                    )
                    for tag, srcs in jobs
                    for tier in tiers
                ]
                for f in futs:
                    f.result()
        if chained is not None:
            reader.result()
    return time.perf_counter() - t0


def run_one_card(dev, streams) -> None:
    from vorbispizza_tpu.models.pipeline import BatchSynthesizer
    from vorbispizza_tpu.testing.encode import chain_streams
    from vorbispizza_tpu.utils import link

    use_oracle = oracle_available()
    log(
        "s16 reference: "
        + (
            "libvorbisfile oracle"
            if use_oracle
            else "quantized float64 anchor (libvorbisfile not loadable here)"
        )
    )
    rate = link.d2h_rate_estimate()
    log(
        f"s16 dpack wire family (s16_rice=auto): "
        f"{'rice' if BatchSynthesizer._resolve_rice() else 'width-only'} "
        f"(measured d2h {rate / 1e6:.1f} MB/s, best of "
        f"{link._PROBE_PULLS} {link._PROBE_BYTES >> 20} MB pulls)"
    )

    phases = [
        ("a.stereo_corpus", [n for n in streams if n.startswith("corpus_")]),
        ("b.surround_5.1", ["surround"]),
        ("c.chain_members", ["chain_a", "chain_b"]),
    ]
    items = {
        label: [(streams[n][1], streams[n][2]) for n in names]
        for label, names in phases
    }
    chained = chain_streams(streams["chain_a"][2], streams["chain_b"][2])

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as ref_pool:
        # the float64 anchor runs on the host while XLA compiles
        refs = {
            label: ref_pool.submit(references, its, use_oracle)
            for label, its in items.items()
        }
        log(f"warm-up: compile + first run of every program, {WARM_WORKERS} threads")
        warm_s = warm_up(
            [(label, [d for _, d in its]) for label, its in items.items()], chained
        )
        log(f"warm-up total: {warm_s:.1f} s, peak_bytes_in_use={peak_bytes(dev)}")

        failures = []
        for label, names in phases:
            audio_s = sum(streams[n][0]["seconds"] for n in names)
            log(f"phase {label}: {len(names)} streams, {audio_s:.0f} s of audio")
            t0 = time.perf_counter()
            try:
                anchors, s16_refs, ref_s = refs[label].result()
                log(f"  {label} reference_s={ref_s:.1f}")
                check_corpus(label, [d for _, d in items[label]], anchors, s16_refs)
            except PhaseFailed as e:
                failures.append(str(e))
            log(
                f"  {label} phase_wall_s={time.perf_counter() - t0:.1f} "
                f"peak_bytes_in_use={peak_bytes(dev)}"
            )

    label = "c.chained_reader"
    log(f"phase {label}: chain_a + chain_b, {2 * SEEKS_PER_STREAM} seeks")
    t0 = time.perf_counter()
    try:
        check_chained(label, chained)
    except PhaseFailed as e:
        failures.append(str(e))
    log(
        f"  {label} phase_wall_s={time.perf_counter() - t0:.1f} "
        f"peak_bytes_in_use={peak_bytes(dev)}"
    )
    if failures:
        raise PhaseFailed("; ".join(failures))


def check_four(devices, items, *, f32_budget=F32_BUDGET) -> dict:
    """Multi-device paths on ``devices`` decoding ``items`` ([(path,
    bytes)]), each against the same decode on ``devices[0]``:

    - decode_corpus_sharded over a 1-D stream mesh of ``devices``;
    - decode_corpus round-robin over ``devices``, one stream per chunk
      (``max_batch_bytes=1``) so every device gets chunks;
    - the ('stream', 'frame') mesh step with its ppermute halo
      (``__graft_entry__.mesh_step_diff``) against a one-device mesh.

    How far each differs from one device is logged as it lands (s16 in
    LSB, f32 in PCM units). The sharded and round-robin decodes must be
    bit-identical to device 0, as they are on four H100s, and within the
    one-card budgets of the float64 anchor and the s16 reference
    (computed on a host thread beside the warm-up). The mesh step must be
    within ``f32_budget`` of one device: its shard-local GEMMs have other
    shapes than the one-device GEMM, for which XLA may pick an algorithm
    that sums in another order. Raises PhaseFailed past any bound.

    The single-device programs compile concurrently first. Programs with
    collectives run from this thread only: launched from several threads
    at once, their per-device launches can interleave in different orders
    and wait on each other's NCCL cliques for ever."""
    from concurrent.futures import ThreadPoolExecutor

    from jax.sharding import Mesh

    import __graft_entry__ as graft
    from vorbispizza_tpu.parallel.corpus import decode_corpus_sharded

    res = {}

    def note(key, value):
        res[key] = value
        log(f"  f.four_device {key}={value}")

    mesh = Mesh(np.array(devices), ("stream",))
    tiers = ("s16", "f32")
    sources = [d for _, d in items]

    def single(tier):
        return _decode(sources, tier, devices=devices[:1], max_batch_bytes=1)

    def sharded(tier):
        t0 = time.perf_counter()
        outs = decode_corpus_sharded(sources, mesh, output=tier)
        return outs, time.perf_counter() - t0

    def round_robin(tier):
        return _decode(sources, tier, devices=devices, max_batch_bytes=1)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=WARM_WORKERS) as pool:
        refs = pool.submit(references, items, oracle_available())
        warm = [
            pool.submit(fn, tier) for fn in (single, round_robin) for tier in tiers
        ]
        for f in warm:
            f.result()
        note("single_device_warm_up_s", round(time.perf_counter() - t0, 3))
        anchors, s16_refs, ref_s = refs.result()
    note("references_s", round(ref_s, 3))

    errors = []
    for tier in tiers:
        ref, ref_s = single(tier)
        note(f"single_{tier}_wall_s", round(ref_s, 3))
        if tier == "s16":
            want, bound = s16_refs, S16_BUDGET_LSB
        else:
            want, bound = anchors, f32_budget
        for name, fn, timing in (
            ("sharded", sharded, "first_call"),
            ("round_robin", round_robin, "wall"),
        ):
            got, got_s = fn(tier)
            note(f"{name}_{tier}_{timing}_s", round(got_s, 3))
            diff = max_abs(got, ref)
            note(f"{name}_{tier}_vs_single", diff)
            if diff != 0:
                errors.append(f"{name} {tier} differs from device 0 by {diff:.3e}")
            err = max_abs(got, want)
            note(f"{name}_{tier}_vs_anchor", err)
            if not err <= bound:
                errors.append(f"{name} {tier} {err:.3e} from the anchor > {bound}")

    t0 = time.perf_counter()
    step_diff = graft.mesh_step_diff(devices)
    note("mesh_step_first_call_s", round(time.perf_counter() - t0, 3))
    note("mesh_step_vs_single", step_diff)
    if not step_diff <= f32_budget:
        errors.append(f"mesh step {step_diff:.3e} from one device > {f32_budget}")
    if errors:
        raise PhaseFailed("f.four_device: " + "; ".join(errors))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four",
        action="store_true",
        help="run only the multi-device paths, on four cards",
    )
    args = ap.parse_args(argv)

    import jax

    from vorbispizza_tpu.utils.device import card_names, require_gpu

    dev = require_gpu(jax, "chip_smoke")
    devices = jax.devices()
    log(f"jax {jax.__version__} device_kind={dev.device_kind} count={len(devices)}")
    for line in card_names():
        log(f"nvidia-smi: {line}")

    from vorbispizza_tpu import native
    from vorbispizza_tpu.config import VorbisConfig
    from vorbispizza_tpu.testing.smoke_data import DATA, load_streams
    from vorbispizza_tpu.utils.cache import configure

    log(f"compile cache: {configure(jax)}")
    t0 = time.perf_counter()
    if not (VorbisConfig.default.use_native_frontend and native.available()):
        raise SystemExit(f"chip_smoke: native front end unavailable: {native.build_error()}")
    info = native.build_info()
    log(
        f"native front end: {info['path']} "
        f"({'built in %.1f s' % info['build_s'] if info['build_s'] is not None else 'prebuilt'}, "
        f"load {time.perf_counter() - t0:.1f} s)"
    )
    streams = load_streams()
    log(
        f"input source: committed streams {DATA} "
        f"({len(streams)} files, made by tools/make_smoke_data.py)"
    )
    for name, (_, _, data) in streams.items():
        if native.scan_ogg_arrays(data) is None:
            raise SystemExit(f"chip_smoke: native Ogg scan rejected {name}")

    t0 = time.perf_counter()
    try:
        if args.four:
            if len(devices) < 4:
                raise SystemExit(f"chip_smoke --four: needs 4 devices, have {len(devices)}")
            devices = devices[:4]
            # four short stereo streams (the chain members, twice): four
            # cards cost four times as much per second, and what is
            # checked here is agreement with one device, not size
            items = [(streams[n][1], streams[n][2]) for n in ("chain_a", "chain_b") * 2]
            log(
                f"phase f.four_device: {len(items)} streams over "
                f"{len(devices)} devices"
            )
            check_four(devices, items)
        else:
            run_one_card(dev, streams)
    except PhaseFailed as e:
        log(f"FAILED: {e}")
        return 1
    log(f"total_wall_s={time.perf_counter() - t0:.1f} peak_bytes_in_use={peak_bytes(dev)}")
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
