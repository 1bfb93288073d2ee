"""Host set-up that must follow the machine the program runs on: the
compile-cache location and the native front end's build key."""

import os
import pathlib

import pytest

from vorbispizza_tpu import native
from vorbispizza_tpu.utils import cache

REPO = pathlib.Path(__file__).resolve().parent.parent


class _FakeJax:
    """Records config updates instead of applying them."""

    def __init__(self):
        self.updates = {}
        self.config = self

    def update(self, name, value):
        self.updates[name] = value


def test_cache_follows_env_and_sets_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV, str(tmp_path / "cc"))
    fake = _FakeJax()
    assert cache.configure(fake) == str(tmp_path / "cc")
    assert fake.updates == {}
    assert cache.jit_cache_dir() == str(tmp_path / "cc")


def test_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(cache.ENV, raising=False)
    fake = _FakeJax()
    d = cache.configure(fake)
    assert d == str(REPO / ".jax_cache")
    assert os.path.isdir(d)
    assert fake.updates["jax_compilation_cache_dir"] == d


@pytest.mark.parametrize(
    "change",
    [
        ("int x;", native._FLAGS, "cpu A"),  # source
        ("int y;", native._FLAGS + ("-DNDEBUG",), "cpu A"),  # flags
        ("int y;", native._FLAGS, "cpu B"),  # host CPU
    ],
)
def test_native_build_key_changes(change):
    base = native.build_key(b"int y;", native._FLAGS, "cpu A")
    src, flags, cpu = change
    assert native.build_key(src.encode(), flags, cpu) != base
    assert native.build_key(b"int y;", native._FLAGS, "cpu A") == base


def test_native_library_is_built_for_this_host():
    assert native.available(), native.build_error()
    info = native.build_info()
    src = (REPO / "vorbispizza_tpu" / "native" / "frontend.cpp").read_bytes()
    key = native.build_key(src, native._FLAGS, native.host_cpu())
    assert pathlib.Path(info["path"]).name == f"_frontend-{key}.so"
    assert pathlib.Path(info["path"]).parent.name == "build"
