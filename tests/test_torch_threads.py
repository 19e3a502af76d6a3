"""The port's host path under threads (the worker runtime's ranks and the
service's queries share one process and one card): the launch counters
count every concurrent launch, the first use of a kernel from many
threads builds its library once, a library is installed whole (by
rename), the pinned staging buffers are the process's, and the thread
ranks run fused batches one at a time with the reference's bytes. The
CUDA build is stubbed out: there is no nvcc here."""
import threading

import pytest

from relational_parity import assert_bytes_equal, backend_kw


@pytest.fixture(scope="module", autouse=True)
def torch():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def test_launch_counter_counts_every_concurrent_launch():
    from repro_torch.kernels import nvcc, ops
    c = nvcc.LaunchCounter()
    n_threads, per = 8, 20_000
    barrier = threading.Barrier(n_threads)

    def bump():
        barrier.wait(timeout=30)
        for _ in range(per):
            c.add()

    threads = [threading.Thread(target=bump) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert c.count == n_threads * per
    c.count = 0
    assert c.count == 0
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


def test_first_load_from_many_threads_builds_once(monkeypatch, tmp_path):
    """Threads reaching a kernel at once start one build of its library,
    and all get the one loaded library (build and load stubbed: no nvcc
    here)."""
    import time
    from repro_torch.kernels import nvcc
    builds, loads = [], []

    def compile_all(sources):
        builds.append(list(sources))
        time.sleep(0.2)  # a slow build: the others must wait, not rebuild
        return [tmp_path / "lib.so"]

    monkeypatch.setattr(nvcc, "compile_all", compile_all)
    monkeypatch.setattr(nvcc.ctypes, "CDLL",
                        lambda path: loads.append(path) or object())
    monkeypatch.setattr(nvcc, "_LOADED", {})
    source = tmp_path / "k.cu"
    got = []
    barrier = threading.Barrier(6)

    def first_use():
        barrier.wait(timeout=30)
        got.append(nvcc.load(source))

    threads = [threading.Thread(target=first_use) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 6 and all(g is got[0] for g in got)


def test_compile_all_installs_each_library_by_rename(monkeypatch,
                                                     tmp_path):
    """A library appears under its final name only whole: nvcc writes a
    temporary file beside it, which is renamed into place (a reader in
    another process never loads a half-written library)."""
    import os
    import sys
    from repro_torch.kernels import nvcc
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'w').write('lib')\nprint('ptxas info')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc, "nvcc_path", lambda: str(fake))
    renames = []
    real_replace = os.replace

    def replace(src, dst):
        renames.append((src, dst))
        assert not os.path.exists(dst)
        real_replace(src, dst)

    monkeypatch.setattr(nvcc.os, "replace", replace)
    source = tmp_path / "k.cu"
    source.write_text("// kernel")
    lib, = nvcc.compile_all([source])
    assert lib.read_text() == "lib" and lib.parent == tmp_path / "build"
    assert [dst for _, dst in renames] == [lib]
    assert "ptxas info" in lib.with_suffix(".log").read_text()
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])


def test_staging_buffers_are_the_processs_under_their_locks(torch):
    """Threads get one staging buffer per (device, use), the process's,
    each with its lock (the pinned memory held does not grow with the
    threads that use it)."""
    from repro_torch.kernels import transfer
    cpu = torch.device("cpu")
    got = []

    def use():
        got.append(transfer.staging(cpu, "test"))

    threads = [threading.Thread(target=use) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(got) == 6 and all(g is got[0] for g in got)
    assert transfer.staging(cpu, "other") is not got[0]
    assert got[0].lock.acquire(timeout=1)
    got[0].lock.release()


@pytest.mark.parametrize("expr_backend", ["numpy", "torch"])
def test_thread_ranks_run_fused_batches_one_at_a_time(monkeypatch,
                                                      expr_backend):
    """Q1 over 4 thread workers: no two ranks are ever inside a fused
    batch at once, and the bytes and per-rank shuffle bytes are the
    reference's numpy workers'."""
    import time

    from repro.apps.tpch import LineitemQ1 as RefQ1
    from repro.apps.tpch import q1_pricing_summary as ref_q1
    from repro.core import Session as RefSession
    from repro_torch.apps.tpch import LineitemQ1, q1_pricing_summary
    from repro_torch.core import Session
    from repro_torch.core.exprc import FusedStage
    from repro_torch.data.synthetic import tpch_q1_lineitems
    lines = tpch_q1_lineitems(40_000, seed=8)
    inside, most, guard = [0], [0], threading.Lock()
    call = FusedStage.__call__

    def spy(self, vl):
        with guard:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        time.sleep(0.001)  # give another rank the chance to enter
        try:
            return call(self, vl)
        finally:
            with guard:
                inside[0] -= 1

    rs = RefSession(backend="workers", num_workers=4, expr_backend="numpy")
    want = ref_q1(rs.store, rs.load("l", lines, RefQ1).set_name,
                  session=rs).collect()
    monkeypatch.setattr(FusedStage, "__call__", spy)
    ps = Session(backend="workers", num_workers=4, **backend_kw(expr_backend))
    got = q1_pricing_summary(ps.store, ps.load("l", lines,
                                               LineitemQ1).set_name,
                             session=ps).collect()
    assert_bytes_equal([want, got])
    assert [w.shuffle_bytes for w in ps.executor.worker_stats] == [
        w.shuffle_bytes for w in rs.executor.worker_stats]
    assert most[0] == 1
