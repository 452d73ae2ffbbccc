"""The port's serving path against the JAX package's, on the CPU.

- ``serving.MicroBatcher`` with a stub scorer: each scenario (grouping,
  bad rows, submit after close, an error then recovery, deferred results,
  ``max_queue`` shedding, close while a batch is in flight, stragglers at
  close, long audio) runs through both packages' batchers and must give the
  same observable outcome; the port's also reads back a torch tensor;
- the HTTP server: the port's and the JAX package's, each built by its
  CLI's ``--serve_http`` from one tiny fp32 checkpoint and bound to
  ``127.0.0.1:0``, answer the same requests (JSON paths, WAV and FLAC
  uploads, ``/score_batch``, client errors) with the same JSON, scores
  within 1e-5; with a stub scorer, both shed a full queue with the same
  503 and both drain on SIGTERM;
- ``--serve`` on stdin, in-process, gives the JAX CLI's reply lines within
  1e-5, with and without ``--calibrate``, ``--serve_batch`` and
  ``--long_audio``, and an ``ERROR`` line for a file that does not decode;
- usage errors exit 2 with the JAX CLI's text, and without a card and
  without ``--device cpu`` ``--serve`` exits 1.

Every thread join and HTTP call has a timeout; no test waits on a sleep.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

import jax_native_ready
import scl_deepfake_audio_detection_tpu.native as jnative
from scl_deepfake_audio_detection_tpu import serving as jserving
from scl_deepfake_audio_detection_tpu.cli import main as jax_main
from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_tpu.train import scoring as jscoring
from scl_deepfake_audio_detection_torch import serving as pserving
from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.train import scoring as pscoring
from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

# as tests/test_torch_cli_eval.py: one throwaway multi-threaded exp first
torch.exp(torch.zeros(1 << 20))
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "conf-eval-only.yaml")
ATOL = 1e-5
CUT = 1000
SR = 16000
TIMEOUT = 120
PACKAGES = {"jax": (jserving, jscoring), "port": (pserving, pscoring)}


def fake_batch_score(block):
    """A deterministic per-row stand-in for the model: [sb, 2]."""
    m = block.mean(axis=1).astype(np.float64)
    return np.stack([-np.abs(m), np.tanh(m * 100.0)], axis=1).astype(np.float32)


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=CUT) * 0.1).astype(np.float32) for _ in range(n)]


def _gated(started, release):
    def slow(block):
        started.set()
        assert release.wait(timeout=TIMEOUT)
        return fake_batch_score(block)

    return slow


# ----------------------------------------------------------- MicroBatcher


def _grouping(sv, _):
    shapes = []

    def spy(block):
        shapes.append(block.shape)
        return fake_batch_score(block)

    b = sv.MicroBatcher(spy, cut=CUT, batch_size=4, max_wait_ms=TIMEOUT * 1e3)
    try:
        rows = _rows(4)
        outs = [h.wait() for h in [b.submit_async(r) for r in rows]]  # fills one batch
        grouped = (list(shapes), b.batches, b.served)
    finally:
        b.close()
    b = sv.MicroBatcher(spy, cut=CUT, batch_size=4, max_wait_ms=0)
    try:
        lone = b.submit(rows[0])  # a partial batch, padded to the same shape
    finally:
        b.close()
    return {"grouped": grouped, "outs": np.stack(outs).tolist(), "lone": lone.tolist(),
            "last_shape": shapes[-1]}


def _bad_rows(sv, _):
    out = []
    b = sv.MicroBatcher(fake_batch_score, cut=CUT, batch_size=2, max_wait_ms=0)
    try:
        for bad in (np.zeros(CUT + 1, np.float32), np.zeros((2, CUT), np.float32)):
            with pytest.raises(ValueError) as e:
                b.submit(bad)
            out.append(str(e.value))
    finally:
        b.close()
    for kw in ({"batch_size": 0}, {"max_queue": 0}):
        with pytest.raises(ValueError) as e:
            sv.MicroBatcher(fake_batch_score, cut=CUT, **kw)
        out.append(str(e.value))
    return out


def _submit_after_close(sv, _):
    b = sv.MicroBatcher(fake_batch_score, cut=CUT, batch_size=2, max_wait_ms=0)
    b.close()
    out = []
    for call in (lambda: b.submit(np.zeros(CUT, np.float32)),
                 lambda: b.submit_long(np.zeros(CUT * 2, np.float32))):
        with pytest.raises(RuntimeError) as e:
            call()
        out.append(str(e.value))
    b.close()  # idempotent
    return out


def _error_then_recovery(sv, _):
    state = {"fail": True}

    def flaky(block):
        if state["fail"]:
            raise FloatingPointError("nan in scores")
        return fake_batch_score(block)

    b = sv.MicroBatcher(flaky, cut=CUT, batch_size=2, max_wait_ms=0)
    try:
        with pytest.raises(RuntimeError) as e:
            b.submit(np.zeros(CUT, np.float32))
        state["fail"] = False
        out = b.submit(np.full(CUT, 0.01, np.float32))
        return {"error": str(e.value), "after": out.tolist(), "errors": b.errors,
                "served": b.served}
    finally:
        b.close()


class Deferred:
    """An unread result: read back through ``__array__``, as a device
    array is."""

    def __init__(self, arr, fail):
        self.arr, self.fail = arr, fail

    def __array__(self, dtype=None, copy=None):
        if self.fail:
            raise FloatingPointError("readback nan")
        return self.arr


def _deferred(sv, _):
    calls = {"n": 0}

    def deferred_score(block):
        calls["n"] += 1
        return Deferred(fake_batch_score(block), fail=calls["n"] == 2)

    b = sv.MicroBatcher(deferred_score, cut=CUT, batch_size=1, max_wait_ms=0)
    try:
        results = []
        for h in [b.submit_async(r) for r in _rows(5, seed=1)]:
            try:
                results.append(h.wait().tolist())
            except RuntimeError as e:
                results.append(str(e))
    finally:
        b.close()
    return {"results": results, "errors": b.errors, "served": b.served,
            "batches": b.batches}


def _max_queue(sv, _):
    release, started = threading.Event(), threading.Event()
    b = sv.MicroBatcher(_gated(started, release), cut=CUT, batch_size=1, max_wait_ms=0,
                        max_queue=2)
    try:
        row = np.zeros(CUT, np.float32)
        hs = [b.submit_async(row)]  # the worker takes it and blocks
        assert started.wait(timeout=TIMEOUT)
        hs += [b.submit_async(row), b.submit_async(row)]  # the queue is full
        with pytest.raises(sv.ServerBusy) as e:
            b.submit_async(row)
        rejected = b.rejected
        release.set()
        outs = [h.wait().tolist() for h in hs]
        again = b.submit(row).tolist()  # drained: accepted again
        return {"busy": str(e.value), "rejected": (rejected, b.rejected), "outs": outs,
                "again": again}
    finally:
        release.set()
        b.close()


def _close_in_flight(sv, _):
    release, started = threading.Event(), threading.Event()
    b = sv.MicroBatcher(_gated(started, release), cut=CUT, batch_size=2, max_wait_ms=0)
    b._join_timeout_s = 0.2
    h = b.submit_async(np.zeros(CUT, np.float32))
    assert started.wait(timeout=TIMEOUT)
    b.close()  # the join times out; the worker's stop must be posted again
    release.set()
    out = h.wait().tolist()
    b._worker.join(timeout=TIMEOUT)
    return {"out": out, "worker_alive": b._worker.is_alive()}


def _stragglers(sv, _):
    b = sv.MicroBatcher(fake_batch_score, cut=CUT, batch_size=2, max_wait_ms=0)
    b._q.put(sv._STOP)  # the worker exits while a request is queued behind it
    b._worker.join(timeout=TIMEOUT)
    straggler = sv._Request(np.zeros(CUT, np.float32))
    b._q.put(straggler)
    b.close()
    with pytest.raises(RuntimeError) as e:
        straggler.wait()
    return {"error": str(e.value), "errors": b.errors, "alive": b._worker.is_alive()}


def _long_audio(sv, scoring):
    wav = (np.random.default_rng(3).normal(size=int(CUT * 2.5)) * 0.1).astype(np.float32)
    b = sv.MicroBatcher(fake_batch_score, cut=CUT, batch_size=4, max_wait_ms=0)
    try:
        got = b.submit_long(wav)
    finally:
        b.close()
    # a row and a long clip fill one group of two: the serial path scores both
    b = sv.MicroBatcher(fake_batch_score, cut=CUT, batch_size=2, max_wait_ms=TIMEOUT * 1e3)
    try:
        row = np.full(CUT, 0.01, np.float32)
        h_row = b.submit_async(row)
        mixed = b.submit_long(np.full(int(CUT * 1.5), 0.01, np.float32))
        row_out = h_row.wait()
    finally:
        b.close()
    want = scoring.score_long_audio(wav, fake_batch_score, window=CUT, batch=4)
    return {"long": got.tolist(), "direct": np.asarray(want).tolist(),
            "mixed": mixed.tolist(), "row": row_out.tolist(), "errors": b.errors,
            "served": b.served}


SCENARIOS = {f.__name__[1:]: f for f in (
    _grouping, _bad_rows, _submit_after_close, _error_then_recovery, _deferred, _max_queue,
    _close_in_flight, _stragglers, _long_audio)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_microbatcher_behaves_like_jax(name):
    got, want = (SCENARIOS[name](*PACKAGES[p]) for p in ("port", "jax"))
    assert got == want
    if name == "grouping":
        assert got["grouped"] == ([(4, CUT)], 1, 4) and got["last_shape"] == (4, CUT)
    elif name == "deferred":
        assert sum(isinstance(r, str) and "readback nan" in r for r in got["results"]) == 1
        assert (got["errors"], got["served"]) == (1, 5)
    elif name == "max_queue":
        assert "max_queue" in got["busy"] and got["rejected"] == (1, 1)
    elif name == "close_in_flight":
        assert not got["worker_alive"]
    elif name == "stragglers":
        assert "closed before scoring" in got["error"] and got["errors"] == 1
    elif name == "long_audio":
        assert got["long"] == got["direct"] and got["errors"] == 0


def test_microbatcher_reads_back_a_torch_tensor():
    """The port's scorer returns the unread device tensor; the worker reads
    it back with ``cpu()``, two batches in flight."""
    b = pserving.MicroBatcher(lambda blk: torch.from_numpy(fake_batch_score(blk)), cut=CUT,
                              batch_size=1, max_wait_ms=0)
    try:
        rows = _rows(3, seed=2)
        outs = [h.wait() for h in [b.submit_async(r) for r in rows]]
    finally:
        b.close()
    for r, o in zip(rows, outs):
        assert isinstance(o, np.ndarray)
        np.testing.assert_array_equal(o, fake_batch_score(r[None])[0])
    assert (b.batches, b.served, b.errors) == (3, 3, 0)


# ------------------------------------------------------------------ HTTP


def _request(url, data=None, headers=None):
    """(status, parsed JSON or text, headers) of one call; HTTP errors too."""
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            status, body, hdrs = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        status, body, hdrs = e.code, e.read(), e.headers
    text = body.decode()
    return status, json.loads(text) if hdrs["Content-Type"] == "application/json" else text, \
        hdrs.get("Retry-After")


class _Running:
    """A server on its own thread, shut down and joined on exit."""

    def __init__(self, server):
        self.server = server
        host, port = server.server_address[:2]
        self.base = f"http://{host}:{port}"
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.close()
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Audio files, one tiny fp32 JAX checkpoint and the common CLI flags."""
    root = tmp_path_factory.mktemp("serving")
    rng = np.random.default_rng(17)
    files = {}
    for name, n in (("a.wav", 9000), ("b.wav", 64600), ("c.wav", 30000),
                    ("long.wav", 100000)):
        files[name] = str(root / name)
        save_wav(files[name], (0.1 * rng.normal(size=n)).astype(np.float32), SR)
    if jax_native_ready.codec():
        x = np.clip(np.round(0.1 * rng.normal(size=20000) * 32768), -32768, 32767) / 32768
        files["d.flac"] = str(root / "d.flac")
        jnative.encode_audio(files["d.flac"], x.astype(np.float32), SR, "flac")
    files["missing.wav"] = str(root / "missing.wav")
    jm = JLinearNLL(ssl=JX.XLSRConfig.tiny(compute_dtype="float32"))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(8)))
    ckpt = str(root / "m.ckpt")
    jckpt.save(ckpt, {"params": params})
    common = ["--config", CONFIG, "--model_path", ckpt, "--ssl_preset", "tiny",
              "--compute_dtype", "float32", "--padding_type", "repeat"]
    return root, files, common


def _cli_server(monkeypatch, side, argv):
    """The server that ``--serve_http`` of ``side``'s CLI builds, unstarted."""
    main, sv = (jax_main, jserving) if side == "jax" else (port_main, pserving)
    got = {}

    def capture(batch_score, **kw):
        got["server"] = sv.make_server(batch_score, **kw)
        return 0

    monkeypatch.setattr(sv, "serve_http", capture)
    dev = ["--device", "cpu"] if side == "port" else []
    assert main(argv + dev) == 0
    return got["server"]


def _close(got, want, path=""):
    """JSON equal, but numbers within ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= ATOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _http_session(base, files):
    """JSON paths, ``/score_batch``, uploads and client errors."""
    out = []
    js = {"Content-Type": "application/json"}
    for name in ("a.wav", "long.wav", "d.flac"):  # the rest go through /score_batch
        if name in files:
            out.append(_request(base + "/score",
                                json.dumps({"path": files[name], "id": name}).encode(), js))
    batch = [files[n] for n in sorted(files)]
    out.append(_request(base + "/score_batch", json.dumps({"paths": batch}).encode(), js))
    for name in ("a.wav", "d.flac"):
        if name in files:
            with open(files[name], "rb") as f:
                body = f.read()
            ctype = "audio/wav" if name.endswith(".wav") else "audio/flac"
            out.append(_request(base + "/score", body,
                                {"Content-Type": ctype, "X-Filename": name}))
    # client errors
    out.append(_request(base + "/score", b"{nope", js))
    out.append(_request(base + "/score", b"{}", js))
    out.append(_request(base + "/score", json.dumps({"path": files["missing.wav"]}).encode(),
                        js))
    out.append(_request(base + "/score", b"", {"Content-Type": "audio/wav"}))
    out.append(_request(base + "/score", b"not audio at all", {"Content-Type": "audio/wav"}))
    out.append(_request(base + "/score_batch", b'{"paths": []}', js))
    out.append(_request(base + "/nope", b"{}"))
    out.append(_request(base + "/nope"))
    return out


def test_http_server_answers_like_jax(served, monkeypatch):
    """With ``--calibrate``, ``--long_audio`` and the int16 wire on, which
    the stdin tests hold without."""
    _, files, common = served
    argv = common + ["--serve_http", "0", "--serve_batch", "2", "--calibrate", "2,0.5",
                     "--long_audio", "--wire_dtype", "int16"]
    answers, health = {}, {}
    for side in ("jax", "port"):
        with _Running(_cli_server(monkeypatch, side, argv)) as run:
            answers[side] = _http_session(run.base, files)
            health[side] = _request(run.base + "/healthz")[1]
            metrics = _request(run.base + "/metrics")[1]
            b = run.server.batcher
            assert f"scl_serve_batches_total {b.batches}" in metrics
            assert f"scl_serve_requests_total {b.served}" in metrics
    _close(answers["port"], answers["jax"])
    codes = [a[0] for a in answers["port"]]
    flac = "d.flac" in files
    assert codes == [200] * (4 + 2 * flac) + [400] * 6 + [404] * 2
    assert health["port"]["calibrated"] and health["port"]["long_audio"]
    keep = ("status", "model", "cut", "batch_size", "long_audio", "calibrated", "served",
            "rejected", "queue_depth", "max_queue")
    assert {k: health["port"][k] for k in keep} == {k: health["jax"][k] for k in keep}


def test_http_503_when_the_queue_is_full_like_jax(tmp_path):
    p = str(tmp_path / "a.wav")
    save_wav(p, np.zeros(CUT, np.float32), SR)
    body, hdr = json.dumps({"path": p}).encode(), {"Content-Type": "application/json"}
    outcomes = {}
    for side, (sv, _) in PACKAGES.items():
        release, started = threading.Event(), threading.Event()
        server = sv.make_server(_gated(started, release), cut=CUT, port=0, batch_size=1,
                                max_wait_ms=0, max_queue=1, model_tag="fake")
        with _Running(server) as run:
            results = []
            posts = [threading.Thread(target=lambda: results.append(
                _request(run.base + "/score", body, hdr))) for _ in range(2)]
            posts[0].start()  # occupies the worker
            assert started.wait(timeout=TIMEOUT)
            posts[1].start()  # waits in the queue until the first is released
            deadline = time.monotonic() + TIMEOUT
            while server.batcher._q.qsize() < 1:
                assert time.monotonic() < deadline
                posts[1].join(timeout=0.01)
            overflow = _request(run.base + "/score", body, hdr)
            release.set()
            for t in posts:
                t.join(timeout=TIMEOUT)
                assert not t.is_alive()
            health = _request(run.base + "/healthz")[1]
            metrics = _request(run.base + "/metrics")[1]
        outcomes[side] = (overflow, sorted(r[0] for r in results), health["rejected"],
                          "scl_serve_rejected_total 1" in metrics)
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0][0] == 503 and outcomes["port"][0][2] == "1"
    assert outcomes["port"][1:] == ([200, 200], 1, True)


SIGTERM_SERVER = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from scl_deepfake_audio_detection_torch.serving import serve_http
def score(block):
    return np.zeros((block.shape[0], 2), np.float32)
raise SystemExit(serve_http(score, cut=1000, port=0, batch_size=2))
"""


def test_serve_http_drains_on_sigterm():
    proc = subprocess.Popen([sys.executable, "-c", SIGTERM_SERVER, REPO],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()  # the banner, printed once SIGTERM is handled
        assert "listening on http://127.0.0.1:" in line, line
        base = line.split("listening on ")[1].split()[0]
        assert _request(base + "/healthz")[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=TIMEOUT) == 0
        assert "draining" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)


# ------------------------------------------------------------ stdin serve


def _serve_stdin(main, argv, lines, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(ln + "\n" for ln in lines)))
    assert main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    return [ln for ln in out if not ln.startswith("loaded checkpoint ")]  # the replies


@pytest.mark.parametrize("extra", [[], ["--serve_batch", "4", "--calibrate", "2,0.5"],
                                   ["--serve_batch", "2", "--long_audio"]],
                         ids=["batch1", "batch4_calibrated", "long_audio"])
def test_stdin_serve_replies_like_jax(served, monkeypatch, capsys, extra):
    _, files, common = served
    lines = [files["a.wav"], f"id-b\t{files['b.wav']}", f"id-m\t{files['missing.wav']}",
             "", f"id-long\t{files['long.wav']}", files["c.wav"]]
    if "d.flac" in files:
        lines.append(f"id-d\t{files['d.flac']}")
    argv = common + ["--serve"] + extra
    want = _serve_stdin(jax_main, argv, lines, monkeypatch, capsys)
    got = _serve_stdin(port_main, argv + ["--device", "cpu"], lines, monkeypatch, capsys)
    assert len(got) == len(want) == len([ln for ln in lines if ln])
    for g, w in zip(got, want):
        gk, gv = g.split("\t", 1)
        wk, wv = w.split("\t", 1)
        assert gk == wk
        if wv.startswith("ERROR"):
            assert gv.split(":")[0] == wv.split(":")[0] and gk == "id-m"
        else:
            assert abs(float(gv) - float(wv)) <= ATOL, (g, w)


@pytest.mark.parametrize("spec", ["1,2,3", "a,b"])
def test_bad_calibrate_spec_exits_2_with_the_jax_text(served, capsys, spec):
    _, _, common = served
    argv = common + ["--serve", "--calibrate", spec]
    assert jax_main(argv) == 2
    want = capsys.readouterr().err
    assert port_main(argv + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert got.strip().splitlines()[-1] == want.strip().splitlines()[-1]
    assert "--calibrate expects 'a,b' (two floats)" in got


def test_serve_and_serve_http_together_exit_2(served, capsys):
    _, _, common = served
    argv = common + ["--serve", "--serve_http", "0"]
    assert jax_main(argv) == 2
    want = capsys.readouterr().err
    assert port_main(argv + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert got.strip() == want.strip().splitlines()[-1]


@pytest.mark.parametrize("mode", [["--serve"], ["--serve_http", "0"]])
def test_serving_without_a_card_exits_1(served, capsys, monkeypatch, mode):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, files, common = served
    monkeypatch.setattr(sys, "stdin", io.StringIO(files["a.wav"] + "\n"))
    assert port_main(common + mode) == 1  # no --device cpu: the card or nothing
    cap = capsys.readouterr()
    assert "no CUDA device" in cap.err and cap.out.strip() == ""
