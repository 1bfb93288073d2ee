"""Entry points: entry() compiles on one device; dryrun_multichip runs on
the virtual CPU mesh."""

import pathlib
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import __graft_entry__ as graft


def test_entry_compiles_and_runs():
    """entry() must hand back the production fused-chunk program family:
    jit-compiling it on one device and running the example wire buffers
    yields the s16 dpack output wire (a non-empty u8 buffer whose header
    word is a plausible payload byte count)."""
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    out.block_until_ready()
    host = np.asarray(out)
    assert host.dtype == np.uint8
    assert host.size > 0
    nbytes = int(host[:4].view(np.uint32)[0]) if host.ndim == 1 else int(
        host.reshape(-1)[:4].view(np.uint32)[0]
    )
    assert 0 < nbytes <= host.size


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_multichip(n):
    """On CPU devices the sharded decode and the mesh step are
    bit-identical to one device."""
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip("not enough virtual devices")
    diffs = graft.dryrun_multichip(devices=devs[:n])
    assert diffs == {"sharded_s16_vs_single": 0, "mesh_step_vs_single": 0.0}


def test_dryrun_multichip_default_takes_cpu_devices():
    """Without a device list the dry run takes n virtual CPU devices."""
    diffs = graft.dryrun_multichip(2)
    assert diffs["sharded_s16_vs_single"] == 0


def test_dryrun_multichip_takes_given_sources():
    """Given streams, the dry run decodes those (here two, so six of the
    eight shards are empty)."""
    from vorbispizza_tpu.testing.smoke_data import chain_members

    srcs = chain_members()
    diffs = graft.dryrun_multichip(devices=jax.devices("cpu")[:8], sources=srcs)
    assert diffs == {"sharded_s16_vs_single": 0, "mesh_step_vs_single": 0.0}


@pytest.mark.parametrize(
    "part, diff", [("sharded_s16_diff", 1), ("mesh_step_diff", 2e-6)]
)
def test_dryrun_multichip_fails_past_bound(monkeypatch, part, diff):
    """A sharded decode that differs from one device at all, or a mesh
    step past the 1e-6 PCM budget, fails the dry run."""
    monkeypatch.setattr(graft, part, lambda *a: diff)
    with pytest.raises(AssertionError, match="differs from one device"):
        graft.dryrun_multichip(devices=jax.devices("cpu")[:2])
