"""The port's command-line tools, examples and trace replayer
(hypermerge_tpu_torch/tools/, hypermerge_tpu_torch/examples/), on the CPU.

- Every case of tests/test_tools.py under its own name on the port, each
  tool with `--device cpu` and its repos made by the port's
  `Repo(device="cpu")`. A case that only reads a tool's output calls the
  module's `main(argv)` in this process; a case whose point is a second
  process (`serve`, `chat`, `watch --connect`, `ls --sock` against a
  daemon, `meta --dht`, a scrub or ls of a repo this process left
  crashed) runs `python -m hypermerge_tpu_torch.<module>`.
- Cross-package: the JAX package's `Repo` writes one repo directory (docs,
  one hyperfile); each package's tool then runs on its own copy, and
  their outputs are equal: `ls` per-doc lines with and without `--audit`,
  `meta` of a doc and of a file, `cat`, `watch --once`, and `scrub
  --dry-run --json` of a torn feed tail under a crash marker (without
  `t_recover_ms`). The reference's tools are loaded from `tools/*.py` by
  path and run in this process with `sys.argv` set.
- The device rule: every tool that opens a repo (and the examples), run
  with no GPU visible and without `--device cpu`, exits 1 with the
  device error before it touches the repo.

Tolerance: exact.
"""

import importlib.util
import io
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import pytest

from hypermerge_tpu_torch.examples import simple
from hypermerge_tpu_torch.repo import Repo as _PortRepo
from hypermerge_tpu_torch.tools import (
    cat,
    cp,
    ls,
    meta,
    profile_trace,
    scrub,
    top,
    watch,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO_ROOT}
PKG = "hypermerge_tpu_torch"


def Repo(**kwargs):
    return _PortRepo(device="cpu", **kwargs)


def _run(module, args, env=None, **kw):
    """`python -m hypermerge_tpu_torch.<module> <args> --device cpu`."""
    return subprocess.run(
        [sys.executable, "-m", f"{PKG}.{module}", *args, "--device", "cpu"],
        capture_output=True,
        text=True,
        timeout=120,
        env=env or ENV,
        cwd=REPO_ROOT,
        **kw,
    )


def _call(mod, argv, capsys):
    """`mod.main(argv + ["--device", "cpu"])` in this process: (exit
    code, stdout, stderr)."""
    code = 0
    try:
        mod.main([*argv, "--device", "cpu"])
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                       else 1)
    out = capsys.readouterr()
    return code, out.out, out.err


def _keeping_recover(fn):
    """`fn()`, with HM_RECOVER put back as it was after it: the scrub
    tools set HM_RECOVER=0 in the environment of the process they run
    in."""
    was = os.environ.get("HM_RECOVER")
    try:
        return fn()
    finally:
        if was is None:
            os.environ.pop("HM_RECOVER", None)
        else:
            os.environ["HM_RECOVER"] = was


def _scrub(argv, capsys):
    """The port's scrub tool in this process."""
    return _keeping_recover(lambda: _call(scrub, argv, capsys))


def _sock_path(tag):
    # a unix socket path holds at most 107 bytes
    return os.path.join(tempfile.gettempdir(),
                        f"hm-tools-{tag}-{uuid.uuid4().hex[:8]}.sock")


def _line_reader(stream):
    """Background reader so a silent process can't block the test past
    its deadline (readline would otherwise hang forever)."""
    q: "queue.Queue" = queue.Queue()

    def pump():
        for line in stream:
            q.put(line)
        q.put(None)

    threading.Thread(target=pump, daemon=True).start()

    def next_line(timeout):
        try:
            return q.get(timeout=timeout)
        except queue.Empty:
            return None

    return next_line


def _flush(repo):
    if repo.back.live is not None:
        repo.back.live.flush_now()


def test_ls_and_watch_once(tmp_path, capsys):
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    url = repo.create({"title": "doc one", "n": 1})
    repo.change(url, lambda d: d.__setitem__("n", 2))
    repo.close()

    code, out, err = _call(ls, [path, "--audit"], capsys)
    assert code == 0, err
    assert url in out
    assert "integrity=OK" in out
    assert "residency=" in out

    code, out, err = _call(watch, [path, url, "--once"], capsys)
    assert code == 0, err
    state = json.loads(out.strip().splitlines()[-1])
    assert state["doc"]["n"] == 2


def test_cat_cp_and_serve(tmp_path, capsys):
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    url = repo.create({"kind": "doc"})
    repo.close()

    # cp a file in, cat it back out
    src = tmp_path / "payload.bin"
    src.write_bytes(b"\x01\x02" * 5000)
    code, out, err = _call(cp, [path, str(src)], capsys)
    assert code == 0, err
    file_url = out.strip().splitlines()[-1]
    assert file_url.startswith("hyperfile:/")
    code, out, err = _call(cat, [path, file_url], capsys)
    assert code == 0, err
    assert "10000 bytes" in err
    cp_back = str(tmp_path / "back.bin")
    code, out, err = _call(cp, [path, file_url, cp_back], capsys)
    assert code == 0, err
    assert open(cp_back, "rb").read() == b"\x01\x02" * 5000

    # cat a doc
    code, out, err = _call(cat, [path, url], capsys)
    assert code == 0, err
    assert json.loads(out.strip().splitlines()[-1])["kind"] == "doc"

    # serve + remote watch over TCP: two processes
    serve = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.tools.serve", path, "--port", "0",
         "--device", "cpu"],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        env=ENV,
        cwd=REPO_ROOT,
    )
    try:
        next_line = _line_reader(serve.stdout)
        line = ""
        deadline = time.time() + 60
        while time.time() < deadline and "serving" not in line:
            line = next_line(timeout=1.0) or ""
        assert "serving" in line, "serve never announced"
        addr = line.rsplit(" on ", 1)[1].strip()
        out = _run("tools.watch", [
            str(tmp_path / "peer"), url, "--connect", addr, "--once",
        ])
        assert out.returncode == 0, out.stderr
        state = json.loads(out.stdout.strip().splitlines()[-1])
        assert state["doc"]["kind"] == "doc"
    finally:
        serve.kill()
        serve.wait(timeout=10)


def test_chat_example_end_to_end(tmp_path):
    """serve + join over real TCP; bob's message reaches alice."""
    serve = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.examples.chat", "serve", "--port",
         "0", "--name", "alice", "--device", "cpu"],
        stdin=subprocess.PIPE,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        env=ENV,
        cwd=REPO_ROOT,
    )
    try:
        read_serve = _line_reader(serve.stdout)
        url = None
        addr = None
        deadline = time.time() + 60
        while time.time() < deadline and (url is None or addr is None):
            line = read_serve(timeout=1.0)
            if line is None:
                continue
            if line.startswith("channel: "):
                url = line.split(" ", 1)[1].strip()
            elif line.startswith("peers join with: "):
                addr = line.split(": ", 1)[1].split(" ")[0].strip()
        assert url and addr, "serve did not announce"

        join = subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.examples.chat", "join", addr,
             url, "--name", "bob", "--device", "cpu"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=ENV,
            cwd=REPO_ROOT,
        )
        try:
            join.stdin.write("hello from bob\n")
            join.stdin.flush()
            got = []
            deadline = time.time() + 60
            while time.time() < deadline:
                line = read_serve(timeout=1.0)
                if line is None:
                    continue
                got.append(line)
                if "hello from bob" in line:
                    break
            assert any("hello from bob" in l for l in got), got
        finally:
            # stdin EOF: the example closes its repo and swarm and exits
            join.stdin.close()
            assert join.wait(timeout=30) == 0, join.stderr.read()
    finally:
        serve.stdin.close()
        try:
            assert serve.wait(timeout=30) == 0
        except subprocess.TimeoutExpired:
            serve.kill()
            raise


def test_simple_example_converges(capsys):
    """examples.simple mirrors the reference's two-repo watch demo
    (reference examples/simple/src/simple.ts)."""
    code, out, err = _call(simple, [], capsys)
    assert code == 0, err
    assert "converged: {'numbers': [1, 2, 3, 4, 5]" in out


def test_meta_tool_docs_and_files(tmp_path, capsys):
    """tools.meta surfaces repo.meta — actor list, clock, history for
    docs; size/mime for hyperfiles (reference tools/Meta.ts)."""
    from hypermerge_tpu_torch.utils import keys as keymod
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    url = repo.create({"n": 0})
    repo.change(url, lambda d: d.__setitem__("n", 1))
    repo.change(url, lambda d: d.__setitem__("m", 2))
    repo.start_file_server(_sock_path("meta"))
    header = repo.files.write(
        io.BytesIO(b"\xab" * 4096), "application/x-blob"
    )
    file_url = header.url
    repo.close()

    code, out, err = _call(meta, [path, url], capsys)
    assert code == 0, err
    m = json.loads(out.strip().splitlines()[-1])
    assert m["type"] == "Document"
    assert m["history"] == 3
    doc_id = validate_doc_url(url)
    assert doc_id in m["actors"]
    assert any(c.startswith(doc_id) for c in m["clock"])

    code, out, err = _call(meta, [path, file_url], capsys)
    assert code == 0, err
    fmeta = json.loads(out.strip().splitlines()[-1])
    assert fmeta["type"] == "File"
    assert fmeta["bytes"] == 4096
    assert fmeta["mimeType"] == "application/x-blob"

    # unknown (but well-formed) url: null + non-zero exit
    bogus = "hyperfile:/" + keymod.create().public_key
    code, out, err = _call(meta, [path, bogus], capsys)
    assert code == 1
    assert out.strip().splitlines()[-1] == "null"


def test_meta_tool_unknown_doc_times_out_to_null(tmp_path, capsys):
    from hypermerge_tpu_torch.utils import keys as keymod
    from hypermerge_tpu_torch.utils.ids import to_doc_url

    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    repo.create({"x": 1})
    repo.close()
    unknown = to_doc_url(keymod.create().public_key)
    code, out, err = _call(meta, [path, unknown, "--timeout", "3"], capsys)
    assert code == 1
    assert out.strip().splitlines()[-1] == "null"


def test_scrub_cli_repairs_crashed_repo(tmp_path, capsys):
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    url = repo.create({"n": 0})
    for i in range(4):
        repo.change(url, lambda d, i=i: d.__setitem__("n", i))
    _flush(repo)
    actor = next(iter(repo.back.docs[url.split("/")[-1]].clock))
    repo.close()

    # crash damage: a torn feed tail + the crash marker
    feed_path = os.path.join(path, "feeds", actor[:2], actor)
    with open(feed_path, "ab") as fh:
        fh.write(b"\x40\x00\x00\x00torn")
    open(os.path.join(path, "repo.dirty"), "wb").close()

    code, out, err = _scrub([path, "--dry-run", "--json"], capsys)
    assert code == 0, err
    report = json.loads(out.strip().splitlines()[-1])
    assert report["bytes_truncated"] > 0, report
    # dry run: damage (and the crash marker) still present
    assert os.path.exists(os.path.join(path, "repo.dirty"))

    code, out, err = _scrub([path, "--audit", "--json"], capsys)
    assert code == 0, err
    report = json.loads(out.strip().splitlines()[-1])
    assert report["bytes_truncated"] > 0, report
    assert report["audit"]["not_ok"] == {}, report

    # repaired for real: reopen reads the full doc, audits clean
    code, out, err = _call(ls, [path, "--audit"], capsys)
    assert code == 0, err
    assert "integrity=OK" in out
    assert "scrub=" in out


def test_ls_surfaces_recovery_status(tmp_path, capsys):
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    url = repo.create({"n": 0})
    for i in range(5):
        repo.change(url, lambda d, i=i: d.__setitem__("n", i))
    _flush(repo)
    repo.close()

    # unclean shutdown marker: the next open (ls itself) recovers
    open(os.path.join(path, "repo.dirty"), "wb").close()
    code, out, err = _call(ls, [path], capsys)
    assert code == 0, err
    assert "crash recovery ran" in out
    assert "scrub=ok" in out or "scrub=recovered" in out


def _serve_thread(sock, **kw):
    from hypermerge_tpu_torch.net.ipc import serve_backend

    t = threading.Thread(
        target=serve_backend,
        args=(sock,),
        kwargs=dict(once=True, device="cpu", **kw),
        daemon=True,
    )
    t.start()
    for _ in range(200):
        if os.path.exists(sock):
            break
        time.sleep(0.05)
    return t


def test_top_over_ipc_seam(tmp_path):
    """tools.top's client polls the backend Telemetry query over the
    net/ipc.py unix socket and renders per-subsystem rates."""
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    repo.create({"n": 1})
    repo.close()

    sock = str(tmp_path / "b.sock")
    t = _serve_thread(sock, repo_path=path)
    client = top.IpcTelemetry(sock)
    try:
        p1 = client.poll()
        p2 = client.poll()
        assert isinstance(p1["counters"], dict) and p1["counters"]
        assert p2["time"] >= p1["time"]
        table = top.format_rows(
            p1, p2, max(p2["time"] - p1["time"], 1e-3)
        )
        # the unix-socket chatter itself shows up as net counters
        assert "[net]" in table
        assert "net.tcp.frames_rx" in table
    finally:
        client.close()
    t.join(15)
    assert not t.is_alive()


def test_meta_dht_probe():
    """tools.meta --dht boots an ephemeral node, bootstraps off the
    fleet, and reports node id + bucket occupancy — the from-outside
    'is the DHT reachable' probe (no repo, no device)."""
    from hypermerge_tpu_torch.net.discovery import DhtNode

    a = DhtNode()
    b = DhtNode(bootstrap=[a.address])
    try:
        b.bootstrap_now()
        out = _run("tools.meta", [
            "--dht", "--bootstrap", f"127.0.0.1:{a.address[1]}",
        ])
        assert out.returncode == 0, out.stderr
        probe = json.loads(out.stdout.strip())
        assert len(probe["node_id"]) == 40
        assert probe["nodes"] >= 1
        assert probe["buckets"]  # at least one occupied bucket
    finally:
        a.close()
        b.close()


def test_meta_dht_probe_unreachable_exits_nonzero():
    from hypermerge_tpu_torch.net.discovery import DhtNode

    dead = DhtNode()
    port = dead.address[1]
    dead.close()
    out = _run(
        "tools.meta", ["--dht", "--bootstrap", f"127.0.0.1:{port}"],
        env={**ENV, "HM_DHT_RPC_TIMEOUT_S": "0.2"},
    )
    assert out.returncode == 1
    assert json.loads(out.stdout.strip())["nodes"] == 0


def test_ipc_dht_daemon_and_ls_swarm_columns(tmp_path, monkeypatch):
    """A net/ipc.py daemon joined via --dht replicates with a fleet
    peer discovered through announce/lookup only, and tools.ls --sock
    renders the dht: header plus the peers=/announce= columns from the
    daemon's Telemetry payload."""
    from hypermerge_tpu_torch.net.discovery import DhtNode, DhtSwarm

    monkeypatch.setenv("HM_DHT_ANNOUNCE_S", "0.2")
    monkeypatch.setenv("HM_DHT_LOOKUP_S", "0.2")
    monkeypatch.setenv("HM_NET_PING_S", "0")
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    url = repo.create({"fleet": True})
    repo.close()

    boot = DhtNode()
    sock = str(tmp_path / "b.sock")
    t = _serve_thread(
        sock, repo_path=path, dht=True,
        dht_bootstrap=[f"127.0.0.1:{boot.address[1]}"],
    )
    peer = Repo(memory=True)
    sw = DhtSwarm(bootstrap=[boot.address])
    peer.set_swarm(sw)
    try:
        # pure-DHT discovery: the peer finds the daemon via lookup
        assert peer.open(url).value(timeout=60) is not None
        out = _run("tools.ls", [path, "--sock", sock],
                   env={**ENV, "HM_RECOVER": "0"})
        assert out.returncode == 0, out.stderr
        assert "dht: node" in out.stdout
        assert "announce=yes" in out.stdout
        assert "peers=1" in out.stdout
    finally:
        peer.close()
        sw.destroy()
        boot.close()
        t.join(20)


def test_meta_stats_snapshot(tmp_path, capsys):
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    repo.create({"n": 1})
    repo.close()
    code, out, err = _call(meta, [path, "--stats"], capsys)
    assert code == 0, err
    snap = json.loads(out.strip())
    # registry-sourced names, not per-object dict scrapes
    assert "storage.barriers" in snap
    assert any(k.startswith("live.") for k in snap)


def test_profile_trace_timeline(tmp_path, capsys):
    """tools.profile_trace replays an HM_TRACE file into the
    busy-vs-wall timeline."""
    from hypermerge_tpu_torch import telemetry
    from hypermerge_tpu_torch.telemetry import trace as ttrace

    ttrace.reset()
    ttrace.enable()
    try:
        for _ in range(3):
            with telemetry.span("live.tick", cat="live"):
                time.sleep(0.002)
        with telemetry.span("pipeline.pack", cat="pipeline"):
            time.sleep(0.005)
        telemetry.instant("live.demote", cat="live")
        trace_path = str(tmp_path / "t.json")
        telemetry.flush_trace(trace_path)
    finally:
        ttrace.disable()
        ttrace.reset()

    profile_trace.main([trace_path, "--threads"])
    out = capsys.readouterr().out
    assert "live.tick" in out and "x3" in out
    assert "concurrency" in out
    profile_trace.main([trace_path, "--by", "cat"])
    assert "pipeline" in capsys.readouterr().out


def test_serve_ipc_read_queries(tmp_path):
    """tools.serve --ipc answers Read queries through the serving tier
    and Telemetry queries with the residency block — one daemon
    replicates to peers AND serves point reads off device-resident
    state."""
    import socket as socketmod

    from hypermerge_tpu_torch import msgs
    from hypermerge_tpu_torch.models import Text
    from hypermerge_tpu_torch.net.tcp import TcpDuplex
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    url = repo.create({"title": "served"})
    repo.change(url, lambda d: d.__setitem__("t", Text("from-hbm")))
    repo.close()
    doc_id = validate_doc_url(url)

    sock_path = str(tmp_path / "serve.sock")
    serve = subprocess.Popen(
        [
            sys.executable, "-m", f"{PKG}.tools.serve", path,
            "--port", "0", "--ipc", sock_path, "--device", "cpu",
        ],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        env=ENV,
        cwd=REPO_ROOT,
    )
    try:
        next_line = _line_reader(serve.stdout)
        deadline = time.monotonic() + 60
        announced = False
        while time.monotonic() < deadline:
            line = next_line(timeout=1.0)
            if line and "serving" in line:
                announced = True
                break
        assert announced, "serve never announced"

        sock = socketmod.socket(socketmod.AF_UNIX, socketmod.SOCK_STREAM)
        sock.connect(sock_path)
        duplex = TcpDuplex(sock, is_client=True)

        replies = {}
        got = threading.Event()

        def on_msg(msg):
            if isinstance(msg, dict) and msg.get("type") == "Reply":
                replies[msg["queryId"]] = msg.get("payload")
                got.set()

        duplex.on_message(on_msg)
        duplex.send(
            msgs.query_msg(
                1,
                msgs.read_query(
                    doc_id, {"kind": "text", "path": ["t"]}
                ),
            )
        )
        assert got.wait(30), "no Read reply"
        assert replies[1] == {"value": "from-hbm"}
        got.clear()
        duplex.send(msgs.query_msg(2, msgs.telemetry_query()))
        assert got.wait(30), "no Telemetry reply"
        tele = replies[2]
        assert "serve" in tele and doc_id in tele["serve"]["resident"]
        assert any(
            k.startswith("serve.") for k in tele["counters"]
        )
        duplex.close()

        # ls --sock lists the DAEMON's live residency (the in-process
        # column would be cold); HM_RECOVER=0 because the daemon holds
        # the dirty marker of its live session
        out = _run("tools.ls", [path, "--sock", sock_path],
                   env={**ENV, "HM_RECOVER": "0"})
        assert out.returncode == 0, out.stderr
        assert "residency=resident(" in out.stdout
    finally:
        serve.kill()
        serve.wait(timeout=10)


def test_scrub_cli_surfaces_journal_state(tmp_path, monkeypatch):
    """The scrub CLI reports the group-commit journal: record/dirty
    counts, replay verdicts, and whether the generation stamp bounded
    the scan — and the dry run preserves the stamp byte-for-byte so
    the later real pass is STILL bounded."""
    monkeypatch.setenv("HM_FSYNC", "1")
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    url = repo.create({"n": 0})
    repo.change(url, lambda d: d.__setitem__("n", 7))
    _flush(repo)
    repo.back._stores.flush_now()
    repo.back.durability.flush_now()
    del repo  # crash: marker + journal stay behind

    env = {**ENV, "HM_FSYNC": "1"}
    out = _run("tools.scrub", [path, "--dry-run", "--json"], env=env)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    wal = report["wal"]
    assert wal["present"] == 1 and wal["session_match"] == 1, wal
    assert wal["bounded"] == 1 and wal["dirty_feeds"] >= 1, wal

    out = _run("tools.scrub", [path], env=env)
    assert out.returncode == 0, out.stderr
    assert "journal:" in out.stdout
    assert "scan bounded to the session ledger" in out.stdout


def test_ls_surfaces_wal_column(tmp_path, monkeypatch):
    """ls's wal= column: a crashed session's docs show their journal
    verdict (checkpointed/replayed); docs untouched by the crashed
    session show clean."""
    monkeypatch.setenv("HM_FSYNC", "1")
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    url_touched = repo.create({"n": 0})
    url_clean = repo.create({"n": 1})
    _flush(repo)
    repo.close()  # clean

    repo2 = Repo(path=path)
    repo2.change(url_touched, lambda d: d.__setitem__("n", 42))
    _flush(repo2)
    repo2.back._stores.flush_now()
    repo2.back.durability.flush_now()
    del repo2  # crash

    out = _run("tools.ls", [path], env={**ENV, "HM_FSYNC": "1"})
    assert out.returncode == 0, out.stderr
    lines = {
        line.split()[0]: line
        for line in out.stdout.splitlines()
        if line.startswith("hypermerge:/")
    }
    assert "wal=checkpointed" in lines[url_touched] or (
        "wal=replayed" in lines[url_touched]
    ), lines[url_touched]
    assert "wal=clean" in lines[url_clean], lines[url_clean]


def test_top_groups_wal_counters(tmp_path):
    """storage.wal.* counters render as their own [wal] rate group."""
    cur = {
        "counters": {
            "storage.wal.appends": 100,
            "storage.wal.fsyncs": 4,
            "storage.wal.bytes": 12800,
            "storage.fsyncs": 9,
        }
    }
    prev = {
        "counters": {
            "storage.wal.appends": 50,
            "storage.wal.fsyncs": 2,
            "storage.wal.bytes": 6400,
            "storage.fsyncs": 9,
        }
    }
    table = top.format_rows(prev, cur, 1.0)
    assert "[wal]" in table
    assert "storage.wal.appends" in table
    assert "(+50.0/s)" in table
    # the non-journal storage counter stays in [storage]
    assert "[storage]" in table


def test_top_service_group(tmp_path):
    """The [service] group renders the overload controller's report
    block: ladder state line, counter rates, per-tenant quota table —
    and claims the service.* counters away from auto-grouping."""
    cur = {
        "counters": {
            "service.shed_reads": 120,
            "service.brownout_reads": 30,
            "service.transitions": 3,
            "storage.fsyncs": 9,
        },
        "service": {
            "state": 2,
            "state_name": "shed",
            "pressure": 1.42,
            "ack_stretch_ms": 25.0,
            "transitions": 3,
            "shed_reads": 120,
            "brownout_reads": 30,
            "deferred_installs": 7,
            "tenants": {
                "conn3": {
                    "admitted": 50,
                    "refused": 120,
                    "quota_occupancy": 0.97,
                },
            },
        },
    }
    prev = {"counters": {"service.shed_reads": 20}}
    table = top.format_rows(prev, cur, 1.0)
    assert "[service]" in table
    assert "state shed" in table
    assert "pressure 1.42" in table
    assert "ack_stretch 25.0ms" in table
    assert "service.shed_reads" in table
    assert "(+100.0/s)" in table
    assert "tenant conn3" in table
    assert "quota 0.97" in table
    # exactly ONE [service] header: the counters don't ALSO
    # auto-group
    assert table.count("[service]") == 1


def test_ls_service_status_line(tmp_path, capsys, monkeypatch):
    """tools.ls prints the service: header off the Telemetry payload
    when the backend runs the overload controller. The reference runs it
    by default (HM_SERVICE=1); the port's default is HM_SERVICE=0 (a
    recorded deviation), so the twin asks for the service plane."""
    monkeypatch.setenv("HM_SERVICE", "1")
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    repo.create({"n": 1})
    repo.close()
    code, out, err = _call(ls, [path], capsys)
    assert code == 0, err
    assert "service: healthy pressure=" in out
    assert "tenants=0" in out


# ---------------------------------------------------------------------------
# cross-package: one reference-written repo, each package's tool on a copy


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"hm_ref_tool_{name}", os.path.join(REPO_ROOT, "tools", f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_call(name, argv, capsys, monkeypatch):
    """The reference's `tools/<name>.py` in this process, `sys.argv`
    set: (exit code, stdout, stderr)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", [f"tools/{name}.py", *argv])
    code = 0
    try:
        _keeping_recover(_ref_tool(name).main)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                       else 1)
    out = capsys.readouterr()
    return code, out.out, out.err


def _port_call(mod, argv, capsys):
    return _keeping_recover(lambda: _call(mod, argv, capsys))


@pytest.fixture(scope="module")
def ref_written(tmp_path_factory):
    """A repo directory the JAX package's `Repo` wrote: three docs (a
    map, a text, a list with a counter) and one 70,000-byte hyperfile.
    Returns (path, doc urls, file url)."""
    from hypermerge_tpu.models import Counter as RefCounter
    from hypermerge_tpu.models import Text as RefText
    from hypermerge_tpu.repo import Repo as RefRepo

    path = str(tmp_path_factory.mktemp("ref-written") / "repo")
    repo = RefRepo(path=path)
    try:
        urls = [repo.create({"title": f"doc {i}", "n": i}) for i in range(3)]
        repo.change(urls[0], lambda d: d.__setitem__("n", 10))
        repo.change(urls[1], lambda d: d.__setitem__("t", RefText("hello")))
        repo.change(urls[1], lambda d: d["t"].insert(5, " world"))
        repo.change(urls[2], lambda d: d.__setitem__("xs", [1, 2, 3]))
        repo.change(urls[2], lambda d: d.__setitem__("c", RefCounter(4)))
        repo.change(urls[2], lambda d: d.increment("c", 3))
        repo.start_file_server(_sock_path("ref"))
        data = bytes((i * 7 + 3) % 251 for i in range(70_000))
        header = repo.files.write(io.BytesIO(data), "application/x-blob")
        for u in urls:
            repo.doc(u)
        if repo.back.live is not None:
            repo.back.live.flush_now()
    finally:
        repo.close()
    return path, urls, header.url


def _copies(ref_written, tmp_path):
    src = ref_written[0]
    out = []
    for who in ("ref", "port"):
        dst = str(tmp_path / who)
        shutil.copytree(src, dst)
        out.append(dst)
    return out


def _doc_lines(out):
    return [line for line in out.splitlines()
            if line.startswith("hypermerge:/")]


@pytest.mark.parametrize("audit", [False, True])
def test_ls_lines_equal_reference(ref_written, tmp_path, capsys, monkeypatch,
                                  audit):
    ref_dir, port_dir = _copies(ref_written, tmp_path)
    flags = ["--audit"] if audit else []
    rc, rout, rerr = _ref_call("ls", [ref_dir, *flags], capsys, monkeypatch)
    pc, pout, perr = _port_call(ls, [port_dir, *flags], capsys)
    assert rc == pc == 0, (rerr, perr)
    assert len(_doc_lines(rout)) == 3
    assert _doc_lines(pout) == _doc_lines(rout)


@pytest.mark.parametrize("what", ["doc", "file"])
def test_meta_json_equal_reference(ref_written, tmp_path, capsys,
                                   monkeypatch, what):
    ref_dir, port_dir = _copies(ref_written, tmp_path)
    url = ref_written[1][1] if what == "doc" else ref_written[2]
    rc, rout, rerr = _ref_call("meta", [ref_dir, url], capsys, monkeypatch)
    pc, pout, perr = _port_call(meta, [port_dir, url], capsys)
    assert rc == pc == 0, (rerr, perr)
    assert pout == rout
    got = json.loads(pout)
    assert got["type"] == ("Document" if what == "doc" else "File")


def test_cat_json_equal_reference(ref_written, tmp_path, capsys, monkeypatch):
    ref_dir, port_dir = _copies(ref_written, tmp_path)
    for url in ref_written[1]:
        rc, rout, rerr = _ref_call("cat", [ref_dir, url], capsys,
                                   monkeypatch)
        pc, pout, perr = _port_call(cat, [port_dir, url], capsys)
        assert rc == pc == 0, (rerr, perr)
        assert pout == rout
    assert json.loads(pout)["c"] == 7


def test_watch_once_json_equal_reference(ref_written, tmp_path, capsys,
                                         monkeypatch):
    ref_dir, port_dir = _copies(ref_written, tmp_path)
    for url in ref_written[1]:
        rc, rout, rerr = _ref_call("watch", [ref_dir, url, "--once"], capsys,
                                   monkeypatch)
        pc, pout, perr = _port_call(watch, [port_dir, url, "--once"], capsys)
        assert rc == pc == 0, (rerr, perr)
        assert pout == rout
    assert json.loads(pout)["doc"]["xs"] == [1, 2, 3]


def test_scrub_dry_run_report_equal_reference(ref_written, tmp_path, capsys,
                                              monkeypatch):
    """A torn tail on one doc's feed under a crash marker: each package's
    `scrub --dry-run --json` on its copy reports the same repair (the
    wall time aside), and leaves the marker's bytes as they were."""
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    ref_dir, port_dir = _copies(ref_written, tmp_path)
    actor = validate_doc_url(ref_written[1][0])
    for d in (ref_dir, port_dir):
        with open(os.path.join(d, "feeds", actor[:2], actor), "ab") as fh:
            fh.write(b"\x40\x00\x00\x00torn")
        with open(os.path.join(d, "repo.dirty"), "wb") as fh:
            fh.write(b"crashed-session")
    argv = ["--dry-run", "--json"]
    rc, rout, rerr = _ref_call("scrub", [ref_dir, *argv], capsys, monkeypatch)
    pc, pout, perr = _port_call(scrub, [port_dir, *argv], capsys)
    assert rc == pc == 0, (rerr, perr)
    want = json.loads(rout.strip().splitlines()[-1])
    got = json.loads(pout.strip().splitlines()[-1])
    assert want["bytes_truncated"] > 0, want
    want.pop("t_recover_ms")
    got.pop("t_recover_ms")
    assert got == want
    for d in (ref_dir, port_dir):
        with open(os.path.join(d, "repo.dirty"), "rb") as fh:
            assert fh.read() == b"crashed-session"


# ---------------------------------------------------------------------------
# the device rule: no GPU and no --device cpu -> exit 1, repo untouched

DEVICE_RULE = {
    "cat": ("tools.cat", ["{repo}", "hypermerge:/x"]),
    "cp": ("tools.cp", ["{repo}", "{file}"]),
    "ls": ("tools.ls", ["{repo}"]),
    "meta": ("tools.meta", ["{repo}", "hypermerge:/x"]),
    "meta-devices": ("tools.meta", ["--devices"]),
    "scrub": ("tools.scrub", ["{repo}"]),
    "serve": ("tools.serve", ["{repo}", "--port", "0"]),
    "top": ("tools.top", ["{repo}", "--once"]),
    "watch": ("tools.watch", ["{repo}", "hypermerge:/x", "--once"]),
    "simple": ("examples.simple", []),
    "chat": ("examples.chat", ["serve", "--port", "0"]),
}


@pytest.fixture(scope="module")
def no_gpu_runs(tmp_path_factory):
    """Every DEVICE_RULE command run once with no GPU visible and without
    `--device cpu`, four at a time (each process spends its time
    importing torch): name -> (the completed process, the repo dir)."""
    root = tmp_path_factory.mktemp("no-gpu")
    payload = root / "payload.bin"
    payload.write_bytes(b"x" * 100)
    env = {**ENV, "CUDA_VISIBLE_DEVICES": ""}

    def run(name):
        module, args = DEVICE_RULE[name]
        repo = str(root / f"repo-{name}")
        argv = [a.format(repo=repo, file=str(payload)) for a in args]
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.{module}", *argv],
            capture_output=True, text=True, timeout=120, env=env,
            cwd=REPO_ROOT, stdin=subprocess.DEVNULL,
        )
        return name, (proc, repo)

    with ThreadPoolExecutor(4) as pool:
        return dict(pool.map(run, DEVICE_RULE))


@pytest.mark.parametrize("name", sorted(DEVICE_RULE))
def test_cli_without_a_gpu_exits_with_the_device_error(no_gpu_runs, name):
    proc, repo = no_gpu_runs[name]
    assert proc.returncode == 1, (proc.stdout, proc.stderr)
    assert "no CUDA device is available" in proc.stderr, proc.stderr
    assert proc.stdout == ""
    assert "Traceback" not in proc.stderr
    # nothing ran on the CPU instead: the repo was never opened
    assert not os.path.exists(repo)
