"""The port stands alone: it loads no JAX and nothing of ``repro``, and
its entry points refuse to drop to the CPU on their own."""
import pathlib
import re
import subprocess
import sys

import numpy as np
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


def test_relational_core_loads_no_planner_and_no_jax():
    """``repro_torch.core`` is the reference's package without its sharding
    planner (whose module imports jax.sharding in the reference)."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); "
            "import repro_torch.core as c, repro_torch.apps.tpch; "
            "assert 'torch' in c.EXPR_BACKENDS and 'jax' not in "
            "c.EXPR_BACKENDS; "
            "bad = [m for m in sys.modules if 'planner' in m or m == 'jax' "
            "or m.startswith(('jax.', 'repro.'))]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_workers_service_and_tools_load_no_jax_and_no_repro():
    """The worker runtime, the query service, the tools and the planlint
    CLI import nothing of JAX and nothing of the reference."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); "
            "import repro_torch.dist, repro_torch.service, "
            "repro_torch.apps.linalg, repro_torch.apps.ml, "
            "repro_torch.analysis.__main__, repro_torch.dist.worker; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_workers_and_service_on_torch_raise_when_there_is_no_card(torch):
    """With no card and no device named, the workers and the service on
    the torch backend (the port's default) raise; they never run on the
    CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.apps import GMM, KMeans, LDAGibbs, LinAlgSession
    from repro_torch.core import Session
    from repro_torch.dist.driver import DistributedExecutor
    from repro_torch.objectmodel import PagedStore
    from repro_torch.service import QueryService
    for kw in ({}, {"expr_backend": "torch"}):
        for kind in ({}, {"worker_kind": "socket",
                          "socket_launch": "thread"}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                Session(backend="workers", num_workers=2, **kind, **kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            QueryService(num_workers=2, **kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DistributedExecutor(PagedStore(), num_workers=2, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LinAlgSession()
    x = np.zeros((8, 2))
    for tool in (KMeans(2, iters=1), GMM(2, iters=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.fit(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LDAGibbs(2, 4, iters=1).fit(np.zeros(0, [("doc", "i8"),
                                                 ("word", "i8"),
                                                 ("count", "i8")]), 1)
    # the host backends need no device
    assert Session(backend="workers", num_workers=2,
                   expr_backend="numpy").executor.device is None
    assert QueryService(num_workers=2,
                        expr_backend="numpy").device is None


def test_remote_worker_with_no_card_reports_the_refusal(torch):
    """``python -m repro_torch.dist.worker`` runs a torch-backend query on
    the card unless given ``--device``: with no card its rank reports the
    refusal to the driver, which raises it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.dist.protocol import StatsFrame
    from repro_torch.dist.worker import worker_main
    from repro_torch.objectmodel import PagedStore

    class Transport:
        def __init__(self):
            self.sent = []

        def send(self, dst, tag, msg):
            self.sent.append((tag, msg))

    tr = Transport()
    ok = worker_main(0, 1, tr, PagedStore(), 8192, None, None, "torch")
    assert not ok and tr.sent[0][0] == "error"
    assert "no CUDA device" in tr.sent[0][1]
    assert not any(isinstance(m, StatsFrame) for _, m in tr.sent)


TRAINING_MODULES = ["repro_torch.optim", "repro_torch.optim.adamw",
                    "repro_torch.optim.schedule", "repro_torch.tree",
                    "repro_torch.engine.train_step",
                    "repro_torch.engine.compression",
                    "repro_torch.checkpoint",
                    "repro_torch.checkpoint.checkpointer",
                    "repro_torch.distributed",
                    "repro_torch.distributed.fault_tolerance",
                    "repro_torch.distributed.elastic",
                    "repro_torch.data.pipeline", "repro_torch.data.tokenizer",
                    "repro_torch.launch.train"]


def test_training_stack_loads_no_jax_and_no_repro():
    """The optimizer, the train step and its compression, the
    checkpointer, the supervisor, the token pipeline and the train
    launcher import nothing of JAX and nothing of the reference, and
    their sources name neither."""
    code = (f"import sys, importlib; "
            f"sys.path.insert(0, {str(ROOT / 'src')!r}); "
            f"[importlib.import_module(m) for m in {TRAINING_MODULES!r}]; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                         r"import repro\.|from repro[. ])", re.M)
    for name in TRAINING_MODULES:
        path = ROOT / "src" / (name.replace(".", "/") + ".py")
        if not path.exists():
            path = path.with_suffix("") / "__init__.py"
        assert not pattern.search(path.read_text()), path


def test_train_loop_without_a_device_raises_when_there_is_no_card(torch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.launch.train import main, train_loop
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop("qwen2_moe", steps=1, batch=1, seq=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "qwen2_moe", "--reduced", "--steps", "1"])
