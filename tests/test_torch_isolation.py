"""The port stands alone: it loads no JAX and nothing of ``repro``, and
its entry points refuse to drop to the CPU on their own."""
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(ROOT / "src")!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro")
assert not bad, bad
print(len(names))
"""


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def test_importing_every_module_loads_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15  # every ported module was imported


def test_sources_name_no_jax_and_no_repro():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                         r"import repro\.|from repro[. ])", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_serve_batch_without_a_device_raises_when_there_is_no_card(torch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import resolve_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batch("qwen25_32b", n_requests=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
