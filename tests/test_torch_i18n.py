"""The port's own message catalogs (lqr_tpu_torch/locale/) against the JAX
package's: the same files, read from inside the port, giving the same
translations."""

import json
import os
import pathlib

import pytest

import lqr_tpu.i18n as ji18n
from lqr_tpu_torch import i18n as ti18n

JAX_DIR = pathlib.Path(ji18n.BUNDLED_DIR)
PORT_DIR = pathlib.Path(ti18n.BUNDLED_DIR)
CATALOGS = sorted(p.name for p in JAX_DIR.glob("*.json"))


@pytest.fixture(autouse=True)
def _fresh_catalogs():
    for mod in (ti18n, ji18n):
        mod.reset()
    yield
    for mod in (ti18n, ji18n):
        mod.reset()


def test_bundled_dir_is_inside_the_port():
    port = pathlib.Path(os.path.abspath(ti18n.__file__)).parent
    assert PORT_DIR.resolve().parent == port.resolve()
    assert PORT_DIR.resolve() != JAX_DIR.resolve()


def test_the_port_bundles_every_catalog():
    assert len(CATALOGS) == 15          # 14 languages and TEMPLATE.json
    assert sorted(p.name for p in PORT_DIR.glob("*.json")) == CATALOGS
    assert ti18n.available_languages() == ji18n.available_languages()


@pytest.mark.parametrize("name", CATALOGS)
def test_catalog_equals_jax(name):
    got = json.loads((PORT_DIR / name).read_text(encoding="utf-8"))
    want = json.loads((JAX_DIR / name).read_text(encoding="utf-8"))
    assert got == want


@pytest.mark.parametrize("lang", ["de", "fr", "de_DE.UTF-8"])
def test_translations_match_jax(monkeypatch, lang):
    monkeypatch.delenv("LQR_TPU_LOCALE_FILE", raising=False)
    monkeypatch.delenv("LQR_TPU_LOCALE_DIR", raising=False)
    monkeypatch.setenv("LANGUAGE", lang)
    catalog = json.loads((JAX_DIR / f"{lang[:2]}.json").read_text(
        encoding="utf-8"))
    msgids = ["Resizing width...", "Resizing height...", "discard mask",
              "BatchCarver needs at least one image",
              "no such file: {path}", "not a msgid of any catalog"]
    for msgid in msgids:
        got = ti18n._(msgid)
        assert got == ji18n._(msgid)
        assert got == catalog.get(msgid, msgid)
    assert ti18n._("Resizing width...") != "Resizing width..."


def test_the_port_reads_its_own_files(monkeypatch):
    """The lookup opens a file under lqr_tpu_torch/locale/, never one of
    the JAX package's."""
    monkeypatch.delenv("LQR_TPU_LOCALE_FILE", raising=False)
    monkeypatch.delenv("LQR_TPU_LOCALE_DIR", raising=False)
    monkeypatch.setenv("LANGUAGE", "fr")
    assert pathlib.Path(ti18n._find_catalog()).parent == PORT_DIR
