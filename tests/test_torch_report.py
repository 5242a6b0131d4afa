"""The port's retry policy, trace report and dataset acquisition against the
JAX package's, after ``tests/test_robustness.py``'s retry cases,
``tests/test_telemetry.py``'s report cases and ``tests/test_data.py``'s
acquisition cases: backoff, jitter and deadline on an injected clock (no
test sleeps), ``fold``, ``coverage`` and the gates equal to the JAX
package's on one TRACE.jsonl written by a drive of the port, and
``acquire`` through injected fetchers and ``file://`` URLs (nothing is
fetched)."""

import json
import os
import random
import urllib.error

import pytest

from fedml_tpu.data import acquire as jax_acquire
from fedml_tpu.robustness import retry as jax_retry
from fedml_tpu.telemetry import report as jax_report
from fedml_tpu_torch import telemetry
from fedml_tpu_torch.data import acquire
from fedml_tpu_torch.robustness.retry import RetryError, RetryPolicy, call_with_retry
from fedml_tpu_torch.telemetry import report
from fedml_tpu_torch.telemetry.tracer import Tracer


class _FakeClock:
    """A monotonic clock that only moves when the code under test sleeps."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, d):
        self.sleeps.append(d)
        self.t += d


class _FixedRng(random.Random):
    def __init__(self, frac):
        super().__init__(0)
        self._frac = frac

    def random(self):
        return self._frac


# ---------------------------------------------------------------------- retry

def _failing(n_failures, exc=ConnectionError):
    calls = []

    def fn():
        calls.append(len(calls))
        if len(calls) <= n_failures:
            raise exc("down")
        return "ok"

    return fn, calls


@pytest.mark.parametrize("module", ["port", "jax"])
def test_retry_backoff_sequence_no_jitter(module):
    """Capped exponential 0.1, 0.2, 0.4, then the 0.5 cap; both packages."""
    mod = jax_retry if module == "jax" else None
    policy_cls = mod.RetryPolicy if mod else RetryPolicy
    call = mod.call_with_retry if mod else call_with_retry
    clock = _FakeClock()
    fn, _ = _failing(4)
    policy = policy_cls(max_attempts=5, base_delay=0.1, multiplier=2.0, max_delay=0.5,
                        jitter=False, retryable=(ConnectionError,))
    assert call(fn, policy=policy, sleep=clock.sleep, clock=clock) == "ok"
    assert clock.sleeps == [0.1, 0.2, 0.4, 0.5]


def test_retry_full_jitter_uses_injected_rng():
    clock = _FakeClock()
    fn, _ = _failing(10)
    policy = RetryPolicy(max_attempts=3, base_delay=1.0, multiplier=2.0, max_delay=10.0,
                         jitter=True, retryable=(ConnectionError,))
    with pytest.raises(RetryError) as ei:
        call_with_retry(fn, policy=policy, sleep=clock.sleep, clock=clock,
                        rng=_FixedRng(0.5))
    assert clock.sleeps == [0.5, 1.0]  # half the cap each time; no sleep after the last
    assert ei.value.attempts == 3
    assert isinstance(ei.value.last, ConnectionError)


def test_retry_jitter_draws_equal_the_jax_packages():
    """The same seeded rng gives the same jittered delays in both."""
    for attempt in range(6):
        a = RetryPolicy(max_delay=3.0).delay_for(attempt, random.Random(attempt))
        b = jax_retry.RetryPolicy(max_delay=3.0).delay_for(attempt, random.Random(attempt))
        assert a == b


def test_retry_deadline_clamps_then_stops():
    clock = _FakeClock()
    fn, calls = _failing(10)
    policy = RetryPolicy(max_attempts=10, base_delay=4.0, multiplier=2.0, max_delay=100.0,
                         jitter=False, deadline=10.0, retryable=(ConnectionError,))
    with pytest.raises(RetryError) as ei:
        call_with_retry(fn, policy=policy, sleep=clock.sleep, clock=clock)
    # 4, then the 8 s draw clamped to the 6 s left; at t = 10 nothing is left
    assert clock.sleeps == [4.0, 6.0]
    assert ei.value.attempts == 3 == len(calls)


def test_retry_deadline_never_overshot_even_with_jitter():
    clock = _FakeClock()
    fn, _ = _failing(10)
    policy = RetryPolicy(max_attempts=10, base_delay=8.0, multiplier=2.0, max_delay=100.0,
                         jitter=True, deadline=10.0, retryable=(ConnectionError,))
    with pytest.raises(RetryError) as ei:
        call_with_retry(fn, policy=policy, sleep=clock.sleep, clock=clock,
                        rng=_FixedRng(1.0))
    assert clock.sleeps == [8.0, 2.0]
    assert clock() == 10.0
    assert ei.value.attempts == 3


def test_retry_non_retryable_passes_through():
    def fn():
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        call_with_retry(fn, policy=RetryPolicy(retryable=(ConnectionError,)),
                        sleep=lambda d: None)


def test_retry_abort_short_circuits():
    clock = _FakeClock()
    with pytest.raises(RetryError) as ei:
        call_with_retry(lambda: "never", policy=RetryPolicy(), sleep=clock.sleep,
                        clock=clock, abort=lambda: True)
    assert ei.value.attempts == 0
    fn, calls = _failing(10)
    with pytest.raises(ConnectionError):
        call_with_retry(fn, policy=RetryPolicy(retryable=(ConnectionError,), jitter=False),
                        sleep=clock.sleep, clock=clock, abort=lambda: len(calls) >= 1)
    assert len(calls) == 1


def test_retry_passes_args_and_returns_value():
    assert call_with_retry(lambda a, b=0: a + b, 2, b=3,
                           policy=RetryPolicy(max_attempts=1)) == 5
    with pytest.raises(ValueError):
        call_with_retry(lambda: 1, policy=RetryPolicy(max_attempts=0))


# ----------------------------------------------------------- download retries

def test_download_retries_flaky_fetcher_then_succeeds(tmp_path):
    clock, state = _FakeClock(), {"calls": 0}

    def flaky(url, dst):
        state["calls"] += 1
        if state["calls"] < 3:
            raise ConnectionResetError("flaky network")
        with open(dst, "wb") as f:
            f.write(b"artifact-bytes")

    dst = tmp_path / "artifact.bin"
    acquire._download("http://example.invalid/a.bin", str(dst), fetcher=flaky,
                      policy=RetryPolicy(max_attempts=4, base_delay=0.1, jitter=False,
                                         retryable=(OSError,)),
                      sleep=clock.sleep)
    assert state["calls"] == 3 and clock.sleeps == [0.1, 0.2]
    assert dst.read_bytes() == b"artifact-bytes"


def test_download_permanent_http_error_not_retried(tmp_path):
    state = {"calls": 0}

    def gone(url, dst):
        state["calls"] += 1
        raise urllib.error.HTTPError(url, 404, "Not Found", {}, None)

    with pytest.raises(RuntimeError, match="HTTP 404"):
        acquire._download("http://example.invalid/gone.bin", str(tmp_path / "x"),
                          fetcher=gone, sleep=lambda d: None)
    assert state["calls"] == 1


def test_download_retry_emits_schema_checked_events(tmp_path):
    calls = {"n": 0}

    def fetcher(url, dst):
        calls["n"] += 1
        if calls["n"] == 1:
            raise urllib.error.HTTPError(url, 503, "unavailable", None, None)
        if calls["n"] == 2:
            raise ConnectionResetError("peer reset")
        open(dst, "wb").close()

    sleeps, t = [], Tracer()
    telemetry.install(t)
    try:
        acquire._download("http://example.invalid/a", str(tmp_path / "a"), fetcher=fetcher,
                          policy=RetryPolicy(max_attempts=4, base_delay=1.0, jitter=False,
                                             retryable=(OSError,)),
                          sleep=sleeps.append)
    finally:
        telemetry.uninstall(t)
    events = t.find_events("download_retry")
    assert [e["attempt"] for e in events] == [0, 1]
    assert [e["status"] for e in events] == ["503", "ConnectionResetError"]
    assert [e["backoff_s"] for e in events] == sleeps == [1.0, 2.0]


# -------------------------------------------------------------- trace report

@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    """TRACE.jsonl of a three-round drive of the port's CLI (MNIST LR, the
    pipelined loop, chaos on, on the CPU)."""
    import torch

    from fedml_tpu_torch.experiments import main_fedavg

    run_dir = tmp_path_factory.mktemp("run")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        main_fedavg.main(["--device", "cpu", "--run_dir", str(run_dir), "--comm_round", "3",
                          "--client_num_in_total", "4", "--client_num_per_round", "2",
                          "--data_dir", str(run_dir / "data"), "--chaos", "1",
                          "--chaos_seed", "7", "--chaos_drop_rate", "0.3"])
    finally:
        torch.set_num_threads(threads)
    return str(run_dir / "TRACE.jsonl")


def test_fold_and_coverage_equal_the_jax_packages_on_a_port_trace(port_trace):
    records = report.load_trace(port_trace)
    assert records == jax_report.load_trace(port_trace)
    mine, ref = report.fold(records), jax_report.fold(records)
    assert mine == ref
    assert mine["rounds"] == 3 and mine["value"] > 0
    assert mine["events"]["round_committed"] == 3 and mine["truncated_lines"] == 0
    assert report.coverage(records) == jax_report.coverage(records) >= 0.95


def test_gates_equal_the_jax_packages_on_a_port_trace(port_trace):
    """``run_gate`` (pass, fail and skip) and ``run_compile_gate`` (the port
    compiles nothing: skip) read the port's report as the JAX package's."""
    rep = report.fold(report.load_trace(port_trace))
    rps = rep["value"]
    for bench in ({"rounds_per_sec": rps * 1.5}, {"rounds_per_sec": rps * 10.0},
                  {"rounds_per_sec": rps, "platform": "tpu", "model": "cnn"},
                  {"arms": {"0": {"rounds_per_sec": rps}}}):
        got = report.run_gate(rep, "/x/BENCH_r05.json", bench)
        assert got == jax_report.run_gate(rep, "/x/BENCH_r05.json", bench)
    assert report.run_gate(rep, "/x/BENCH_r05.json", {"rounds_per_sec": rps * 10.0})[0] is False
    budgets = {"mnist_lr": {"max_compiles": 3}}
    got = report.run_compile_gate(rep, budgets, "mnist_lr")
    assert got == jax_report.run_compile_gate(rep, budgets, "mnist_lr")
    assert got[:2] == (True, True)
    forged = {**rep, "compile": {"requests": 5, "cache_hits": 1, "cache_misses": 4}}
    assert (report.run_compile_gate(forged, budgets, "mnist_lr")
            == jax_report.run_compile_gate(forged, budgets, "mnist_lr"))


def test_load_trace_skips_a_torn_final_line(tmp_path):
    path = str(tmp_path / "TRACE.jsonl")
    t = Tracer(jsonl_path=path)
    with t.span("drive"):
        with t.round(0):
            pass
    t.event("checkpoint_save", step=0)
    t.close()
    with open(path, "a") as f:
        f.write('{"type": "event", "kind": "round_com')
    rep = report.fold(report.load_trace(path))
    assert rep == jax_report.fold(jax_report.load_trace(path))
    assert rep["truncated_lines"] == 1 and rep["rounds"] == 1
    assert rep["events"].get("checkpoint_save") == 1


def test_newest_bench_equals_the_jax_packages(tmp_path):
    """The highest rNN wins, and the non-throughput schemas are skipped by
    name, in both packages."""
    for name, rps in (("BENCH_r03.json", 10.0), ("BENCH_r11.json", 20.0),
                      ("BENCH_SCALE_r99.json", 9999.0), ("BENCH_SUPERSTEP_r99.json", 9999.0)):
        with open(tmp_path / name, "w") as f:
            json.dump({"parsed": {"rounds_per_sec": rps}}, f)
    got = report.newest_bench(str(tmp_path))
    assert got == jax_report.newest_bench(str(tmp_path))
    assert os.path.basename(got[0]) == "BENCH_r11.json"
    assert report.baseline_rounds_per_sec(got[1]) == 20.0
    empty = tmp_path / "empty"
    empty.mkdir()
    assert report.newest_bench(str(empty)) is None


# ---------------------------------------------------------------- acquisition

def test_acquire_dry_run_lists_the_reference_urls(capsys):
    assert acquire.main(["fetch", "femnist", "--dry_run"]) == 0
    out = capsys.readouterr().out
    assert "fed_emnist.tar.bz2" in out and "https://" in out
    assert acquire.CATALOG == jax_acquire.CATALOG


def test_acquire_verify_detects_corruption_and_reads_jax_manifests(tmp_path, capsys):
    d = tmp_path / "data"
    (d / "MNIST" / "raw").mkdir(parents=True)
    f = d / "MNIST" / "raw" / "train-images-idx3-ubyte.gz"
    f.write_bytes(b"payload")
    manifest = {"MNIST/raw/train-images-idx3-ubyte.gz":
                {"sha256": jax_acquire._sha256(str(f)), "bytes": 7}}
    (d / f"mnist.{acquire.MANIFEST}").write_text(json.dumps(manifest))
    assert acquire.verify("mnist", str(d)) == 0  # the JAX package's hash
    f.write_bytes(b"tampered")
    assert acquire.verify("mnist", str(d)) == 1
    assert "CORRUPT" in capsys.readouterr().out
    f.unlink()
    assert acquire.verify("mnist", str(d)) == 1
    assert acquire.verify("nonexistent", str(d)) == 2


def test_acquire_stats_runs_on_the_surrogate(capsys):
    assert acquire.main(["stats", "mnist", "--clients", "4", "--data_dir",
                         "/nonexistent"]) == 0
    out = capsys.readouterr().out
    assert "clients: 4" in out and "class histogram" in out


def test_acquire_fetch_end_to_end_with_file_urls(tmp_path, monkeypatch):
    """fetch through a ``file://`` URL: the artifact, its unpacked member and
    the manifest, which verifies in both packages; a re-fetch trusts the
    copy and leaves no .part file."""
    import tarfile

    src = tmp_path / "remote"
    src.mkdir()
    payload = src / "fed_emnist_train.h5"
    payload.write_bytes(b"h5-bytes")
    tarball = src / "fed_emnist.tar.bz2"
    with tarfile.open(tarball, "w:bz2") as tf:
        tf.add(payload, arcname="fed_emnist_train.h5")
    monkeypatch.setitem(acquire.CATALOG, "femnist",
                        [("fed_emnist.tar.bz2", tarball.as_uri(), "tar")])
    data_dir = tmp_path / "data"
    assert acquire.fetch("femnist", str(data_dir)) == 0
    assert (data_dir / "fed_emnist_train.h5").read_bytes() == b"h5-bytes"
    manifest = json.loads((data_dir / f"femnist.{acquire.MANIFEST}").read_text())
    assert manifest["fed_emnist.tar.bz2"]["bytes"] == tarball.stat().st_size
    assert acquire.verify("femnist", str(data_dir)) == 0
    assert jax_acquire.verify("femnist", str(data_dir)) == 0
    assert acquire.fetch("femnist", str(data_dir)) == 0
    assert not list(data_dir.glob("*.part"))


def test_acquire_fetch_refuses_an_html_interstitial(tmp_path, monkeypatch):
    """A Drive virus-scan page is never recorded as the artifact: fetch
    retries with the page's confirm token and, still given HTML, refuses."""
    import shutil

    page = tmp_path / "interstitial"
    page.write_bytes(b"<!DOCTYPE html><html>Download anyway? confirm=abc123</html>")
    monkeypatch.setitem(acquire.CATALOG, "shakespeare",
                        [("shakespeare/train/data.json",
                          "https://docs.google.com/uc?export=download&id=XYZ", None)])
    calls = []
    monkeypatch.setattr(acquire.urllib.request, "urlretrieve",
                        lambda url, dst: (calls.append(url), shutil.copy(page, dst)))
    data_dir = tmp_path / "data"
    with pytest.raises(RuntimeError, match="HTML page"):
        acquire.fetch("shakespeare", str(data_dir))
    assert len(calls) == 2 and "confirm=abc123" in calls[1]
    assert not list(data_dir.rglob("*.part"))
    assert not (data_dir / f"shakespeare.{acquire.MANIFEST}").exists()


def test_gdrive_retry_url_equals_the_jax_packages(tmp_path):
    page = tmp_path / "page.html"
    page.write_bytes(b"""<!DOCTYPE html><html><body>
<form id="download-form" action="https://drive.usercontent.google.com/download" method="get">
  <input type="hidden" name="id" value="XYZ">
  <input type="hidden" name="confirm" value="t">
  <input type="hidden" name="uuid" value="abc-123">
  <input type="submit" value="Download anyway">
</form></body></html>""")
    url = "https://docs.google.com/uc?export=download&id=XYZ"
    got = acquire._gdrive_retry_url(str(page), url)
    assert got == jax_acquire._gdrive_retry_url(str(page), url)
    assert got.startswith("https://drive.usercontent.google.com/download?")
    assert "uuid=abc-123" in got and "Download" not in got
