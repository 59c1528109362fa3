"""The port's knob registry (tendermint_tpu_torch/knobs.py), the
counterpart of tests/test_knobs.py: every ``TM_CUDA_*`` name in the port
and in chip_smoke.py is registered, each knob has a default and a line of
help, the read path rejects unregistered names, and no knob is read while
a module is imported."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from tendermint_tpu_torch import knobs

ROOT = Path(__file__).resolve().parent.parent


def _port_files():
    return sorted((ROOT / "tendermint_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_tm_cuda_name_is_registered():
    seen = {}
    for path in _port_files():
        for name in re.findall(r"\bTM_CUDA_[A-Z0-9_]+", path.read_text()):
            seen.setdefault(name, path.relative_to(ROOT).as_posix())
    assert {"TM_CUDA_RLC", "TM_CUDA_FIELD_IMPL", "TM_CUDA_BASE_MXU"} <= set(seen)
    assert {n: p for n, p in seen.items() if n not in knobs.KNOWN} == {}


def test_every_knob_has_the_prefix_a_default_and_help():
    assert len(knobs.KNOBS) == len(knobs.KNOWN)
    for k in knobs.KNOBS:
        assert k.name.startswith("TM_CUDA_") and isinstance(k.default, str) and k.doc


def test_read_resolves_at_every_call(monkeypatch):
    monkeypatch.delenv("TM_CUDA_RLC", raising=False)
    assert knobs.read("TM_CUDA_RLC") == "0"
    monkeypatch.setenv("TM_CUDA_RLC", "1")
    assert knobs.read("TM_CUDA_RLC") == "1"
    for name, default, value in (("TM_CUDA_FIELD_IMPL", "auto", "packed"),
                                 ("TM_CUDA_BASE_MXU", "0", "1")):
        monkeypatch.delenv(name, raising=False)
        assert knobs.read(name) == default
        monkeypatch.setenv(name, value)
        assert knobs.read(name) == value
    with pytest.raises(KeyError, match="TM_CUDA_MADE_UP"):
        knobs.read("TM_CUDA_MADE_UP")


def test_no_knob_is_read_at_import():
    """Import every port module with os.environ replaced by a mapping that
    records the names it is asked for."""
    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                     for p in (ROOT / "tendermint_tpu_torch").rglob("*.py"))
    modules = [m.removesuffix(".__init__") for m in modules]
    probe = f"""
import importlib, json, os, sys
import numpy, torch
sys.path.insert(0, {str(ROOT)!r})

class Recording(dict):
    asked = []
    def __getitem__(self, k):
        self.asked.append(k)
        return super().__getitem__(k)
    def get(self, k, default=None):
        self.asked.append(k)
        return super().get(k, default)
    def __contains__(self, k):
        self.asked.append(k)
        return super().__contains__(k)

os.environ = Recording(os.environ)
for m in {modules!r}:
    importlib.import_module(m)
print(json.dumps(sorted(set(k for k in Recording.asked if str(k).startswith("TM_")))))
"""
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []
