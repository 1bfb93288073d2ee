"""chip_smoke.py rehearsed on CPU devices at tiny sizes: its phase
functions, its GPU gate and its committed inputs. The same phases run on
a GPU under the ``gpu`` marker."""

import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from vorbispizza_tpu.testing.smoke_data import load_streams  # noqa: E402

#: the CPU backend's f32 accumulation is noisier than the GPU's; the
#: repo's CPU budget against the float64 anchor (tests/test_corpus.py)
CPU_F32_BUDGET = 2e-6


def _encode(tmp_path, name, channels, seconds, rate, seed, serial=1):
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    data = encode_vorbis(
        make_signal(channels, seconds, rate=rate, kind="music", seed=seed),
        rate=rate,
        quality=0.5,
        serial=serial,
    )
    path = tmp_path / f"{name}.ogg"
    path.write_bytes(data)
    return path, data


CORPORA = {
    "stereo": [(2, 1.0, 44100, 0), (2, 0.7, 44100, 1)],
    "surround": [(6, 0.5, 48000, 100)],
}


def _corpus_phase(tmp_path, kind, f32_budget):
    items = [
        _encode(tmp_path, f"{kind}{i}", *spec)
        for i, spec in enumerate(CORPORA[kind])
    ]
    anchors, s16_refs, _ = chip_smoke.references(
        items, chip_smoke.oracle_available()
    )
    return chip_smoke.check_corpus(
        kind, [d for _, d in items], anchors, s16_refs, f32_budget=f32_budget
    )


@pytest.mark.parametrize("kind", sorted(CORPORA))
def test_check_corpus_cpu(tmp_path, kind):
    res = _corpus_phase(tmp_path, kind, CPU_F32_BUDGET)
    assert res["dpack_width_eq_raw"] and res["dpack_rice_eq_raw"]
    assert res["device_eq_f32"]
    assert res["s16_max_lsb"] <= chip_smoke.S16_BUDGET_LSB
    # the CPU backend is deterministic: both calls of each tier agree
    for tier in ("s16", "f32", "device"):
        assert res[f"{tier}_repeat"] == "bit-identical"


def test_check_corpus_fails_past_budget(tmp_path):
    with pytest.raises(chip_smoke.PhaseFailed, match="f32_max_abs"):
        _corpus_phase(tmp_path, "stereo", -1.0)


def test_check_chained_cpu(tmp_path):
    from vorbispizza_tpu.testing.encode import chain_streams

    _, a = _encode(tmp_path, "a", 2, 1.0, 44100, 200, serial=1)
    _, b = _encode(tmp_path, "b", 2, 0.8, 44100, 201, serial=2)
    res = chip_smoke.check_chained(
        "chain", chain_streams(a, b), f32_budget=CPU_F32_BUDGET
    )
    assert res["streams"] == 2
    assert res["seeks"] == 2 * chip_smoke.SEEKS_PER_STREAM
    assert res["repeat"] == "bit-identical"


def test_warm_up_compiles_what_the_phases_run(tmp_path):
    """After the concurrent warm-up, the phase's own calls (every tier and
    wire) compile no new fused program, and the wire config is back to
    its default."""
    from vorbispizza_tpu.config import VorbisConfig
    from vorbispizza_tpu.models import corpus
    from vorbispizza_tpu.testing.encode import chain_streams

    _, a = _encode(tmp_path, "wa", 2, 0.6, 44100, 300)
    _, b = _encode(tmp_path, "wb", 2, 0.5, 44100, 301, serial=2)
    _, c = _encode(tmp_path, "wc", 6, 0.4, 48000, 302)
    phases = [("p1", [a, b]), ("p2", [c])]
    assert chip_smoke.warm_up(phases, chain_streams(a, b), workers=3) > 0
    cfg = VorbisConfig.default
    assert (cfg.s16_wire, cfg.s16_rice) == ("dpack", "auto")

    def fused_programs():
        return sum(
            1
            for synth in corpus._SYNTH_CACHE.values()
            for key in list(synth._fns)
            if key[0] == "fused"
        )

    before = fused_programs()
    for _, srcs in phases:
        for tier in ("s16", "f32", "device"):
            chip_smoke._decode(srcs, tier)
        chip_smoke._decode(srcs, "s16", wire="raw")
        chip_smoke._decode(srcs, "s16", rice="on")
    assert fused_programs() == before


def test_wire_config_restores_on_error():
    from vorbispizza_tpu.config import VorbisConfig

    cfg = VorbisConfig.default
    with pytest.raises(KeyError):
        with chip_smoke.wire_config("raw", "on"):
            assert (cfg.s16_wire, cfg.s16_rice) == ("raw", "on")
            raise KeyError
    assert (cfg.s16_wire, cfg.s16_rice) == ("dpack", "auto")


def test_check_four_cpu():
    """The four-device phase on virtual CPU devices, where every path is
    bit-identical to one device and within budget of the anchor."""
    import jax

    devs = jax.devices("cpu")
    if len(devs) < 4:
        pytest.skip("not enough virtual devices")
    streams = load_streams()
    items = [streams[n][1:] for n in ("chain_a", "chain_b") * 2]
    res = chip_smoke.check_four(devs[:4], items, f32_budget=CPU_F32_BUDGET)
    assert {k: v for k, v in res.items() if k.endswith("_vs_single")} == {
        "sharded_s16_vs_single": 0.0,
        "round_robin_s16_vs_single": 0.0,
        "sharded_f32_vs_single": 0.0,
        "round_robin_f32_vs_single": 0.0,
        "mesh_step_vs_single": 0.0,
    }
    assert res["sharded_s16_vs_anchor"] <= chip_smoke.S16_BUDGET_LSB
    assert res["round_robin_f32_vs_anchor"] <= CPU_F32_BUDGET


def test_check_four_fails_past_mesh_bound(tmp_path, monkeypatch):
    """A mesh step that drifts past the f32 budget from one device fails
    the phase after every comparison has been logged."""
    import jax

    import __graft_entry__ as graft

    monkeypatch.setattr(graft, "mesh_step_diff", lambda devs: 1e-3)
    items = [_encode(tmp_path, "m", 2, 0.3, 44100, 400)] * 2
    with pytest.raises(chip_smoke.PhaseFailed, match="mesh step") as exc:
        chip_smoke.check_four(
            jax.devices("cpu")[:2], items, f32_budget=CPU_F32_BUDGET
        )
    assert "from the anchor" not in str(exc.value)


def test_main_refuses_cpu_backend(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert "needs a GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_committed_inputs_match_manifest_and_generator():
    sys.path.insert(0, str(ROOT / "tools"))
    import make_smoke_data

    streams = load_streams()
    specs = {s[0]: s for s in make_smoke_data.SPECS}
    assert set(streams) == set(specs)
    for name, (m, path, data) in streams.items():
        _, channels, seconds, rate, quality, seed, serial = specs[name]
        assert (m["channels"], m["seconds"], m["rate"]) == (channels, seconds, rate)
        assert (m["quality"], m["seed"], m["serial"]) == (quality, seed, serial)
        assert m["bytes"] == len(data)
        assert hashlib.sha256(data).hexdigest() == m["sha256"]
    corpus = [m for m, _, _ in streams.values() if m["name"].startswith("corpus_")]
    assert len(corpus) == 8
    assert all(120 <= m["seconds"] <= 240 for m in corpus)
    assert sum(m["seconds"] for m in corpus) == 24 * 60


def test_max_abs_and_bitwise_helpers():
    a = [np.zeros((2, 4), np.int16), np.ones((2, 3), np.int16)]
    b = [np.zeros((2, 4), np.int16), np.full((2, 3), 3, np.int16)]
    assert chip_smoke.max_abs(a, b) == 2.0
    assert not chip_smoke.bitwise(a, b)
    assert chip_smoke.bitwise(a, a)
    assert chip_smoke.max_abs(a, [b[0], np.zeros((2, 2), np.int16)]) == float("inf")
    assert chip_smoke.repeat_note(a, b) == "DIFFER max 2.000e+00"
    assert json.loads(json.dumps({"x": chip_smoke.max_abs(a, a)})) == {"x": 0.0}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["chain_a", "surround"])
def test_check_corpus_gpu(gpu_device, name):
    """The smoke's corpus checks on the card, on committed streams (a GPU
    host need not have libvorbisenc)."""
    m, path, data = load_streams()[name]
    anchors, s16_refs, _ = chip_smoke.references(
        [(path, data)], chip_smoke.oracle_available()
    )
    res = chip_smoke.check_corpus(name, [data], anchors, s16_refs)
    assert res["dpack_width_eq_raw"] and res["dpack_rice_eq_raw"]
