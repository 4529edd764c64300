"""Message catalog (the gettext layer).

Same lookup contract as ``lqr_tpu.i18n``: ``LQR_TPU_LOCALE_FILE``, then
``$LQR_TPU_LOCALE_DIR/<lang>.json`` with <lang> from ``LANGUAGE`` /
``LC_ALL`` / ``LC_MESSAGES`` / ``LANG``, then the catalogs bundled with
this package (``lqr_tpu_torch/locale/*.json``, copies of the JAX package's,
which tests/test_torch_i18n.py holds equal). An untranslated msgid passes
through unchanged; ``N_`` marks a msgid for extraction without translating
it.
"""

from __future__ import annotations

import json
import os

BUNDLED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "locale")

_catalog: dict | None = None


def _lang() -> str:
    for var in ("LANGUAGE", "LC_ALL", "LC_MESSAGES", "LANG"):
        v = os.environ.get(var)
        if v and v != "C":
            return v.split(":")[0].split(".")[0]
    return ""


def available_languages() -> list:
    """Language codes with a bundled catalog."""
    try:
        return sorted(f[:-5] for f in os.listdir(BUNDLED_DIR)
                      if f.endswith(".json"))
    except OSError:
        return []


def _find_catalog() -> str | None:
    path = os.environ.get("LQR_TPU_LOCALE_FILE")
    if path:
        return path
    lang = _lang()
    if not lang:
        return None
    for d in (os.environ.get("LQR_TPU_LOCALE_DIR"), BUNDLED_DIR):
        if not d:
            continue
        for cand in (lang, lang.split("_")[0]):
            p = os.path.join(d, f"{cand}.json")
            if os.path.exists(p):
                return p
    return None


def _load() -> dict:
    global _catalog
    if _catalog is not None:
        return _catalog
    path = _find_catalog()
    cat = {}
    if path:
        try:
            with open(path, encoding="utf-8") as f:
                cat = {str(k): str(v) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            cat = {}
    _catalog = cat
    return cat


def reset():
    """Drop the cached catalog (tests / locale switches)."""
    global _catalog
    _catalog = None


def _(msgid: str) -> str:
    """gettext(): translate a user-facing string."""
    return _load().get(msgid, msgid)


def N_(msgid: str) -> str:
    """gettext_noop(): mark a string for extraction without translating
    at definition time; translate later with ``_()``."""
    return msgid
