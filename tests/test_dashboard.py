"""Dashboard REST API + job submission tests (reference:
dashboard/modules/job/tests/test_job_manager.py and the job REST surface
in dashboard/modules/job/job_head.py)."""

import json
import subprocess
import sys
import time
import urllib.request

import pytest

from ray_tpu.cluster_utils import Cluster
from ray_tpu.dashboard.sdk import JobSubmissionClient, JobSubmissionError


@pytest.fixture(scope="module")
def dash(tmp_path_factory):
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    # The dashboard logs to a file: a pipe nobody reads fills at 64 KiB
    # and blocks the dashboard in write(2).
    log = tmp_path_factory.mktemp("dashboard") / "dashboard.log"
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu.scripts.cli", "dashboard",
             "--address", cluster.address, "--host", "127.0.0.1",
             "--port", "0"],
            stdout=out, stderr=subprocess.STDOUT)
    port, buf = None, ""
    deadline = time.time() + 90
    while time.time() < deadline:
        buf = log.read_text("utf-8", "replace")
        if "dashboard listening on" in buf:
            port = int(buf.split("dashboard listening on ")[1]
                       .split()[0].rsplit(":", 1)[1])
            break
        if proc.poll() is not None:
            raise RuntimeError(f"dashboard died during startup ({log}): {buf}")
        time.sleep(0.2)
    assert port, f"dashboard never reported its port ({log}): {buf}"
    client = JobSubmissionClient(f"http://127.0.0.1:{port}")
    try:
        yield cluster, client, port
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        cluster.shutdown()


def _get_json(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def test_state_endpoints(dash):
    cluster, client, port = dash
    nodes = _get_json(port, "/api/nodes")["result"]
    assert len(nodes) == 1 and nodes[0]["alive"]
    assert _get_json(port, "/api/overview")["result"]["cluster"][
        "nodes_alive"] == 1
    # the UI page itself
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
        assert b"ray_tpu dashboard" in r.read()


def test_job_success_joins_cluster(dash):
    cluster, client, port = dash
    # The entrypoint's ray_tpu.init() picks up RAY_TPU_ADDRESS and joins
    # the cluster that launched it.
    code = ("import ray_tpu; ray_tpu.init(); "
            "print('cpus', ray_tpu.cluster_resources().get('CPU')); "
            "print('sub', __import__('os').environ["
            "'RAY_TPU_JOB_SUBMISSION_ID'])")
    sub_id = client.submit_job(entrypoint=f"{sys.executable} -c \"{code}\"")
    rec = client.wait_until_finished(sub_id, timeout=180)
    logs = client.get_job_logs(sub_id)
    assert rec["status"] == "SUCCEEDED", logs
    assert "cpus 4.0" in logs
    assert f"sub {sub_id}" in logs


def test_job_failure(dash):
    cluster, client, port = dash
    sub_id = client.submit_job(
        entrypoint=f"{sys.executable} -c 'import sys; sys.exit(3)'")
    rec = client.wait_until_finished(sub_id, timeout=120)
    assert rec["status"] == "FAILED"
    assert "exit code 3" in rec["message"]


def test_job_stop(dash):
    cluster, client, port = dash
    sub_id = client.submit_job(
        entrypoint=f"{sys.executable} -c 'import time; print(\"up\", "
                   f"flush=True); time.sleep(600)'")
    deadline = time.time() + 60
    while time.time() < deadline:
        if client.get_job_status(sub_id)["status"] == "RUNNING":
            break
        time.sleep(0.2)
    assert client.stop_job(sub_id)
    rec = client.wait_until_finished(sub_id, timeout=60)
    assert rec["status"] == "STOPPED"


def test_job_list_and_delete(dash):
    cluster, client, port = dash
    sub_id = client.submit_job(entrypoint="echo listed-job-marker")
    client.wait_until_finished(sub_id, timeout=120)
    assert any(r["submission_id"] == sub_id for r in client.list_jobs())
    assert "listed-job-marker" in client.get_job_logs(sub_id)
    assert client.delete_job(sub_id)
    assert not any(r["submission_id"] == sub_id for r in client.list_jobs())
    with pytest.raises(JobSubmissionError):
        client.get_job_status(sub_id)


def test_duplicate_submission_id_rejected(dash):
    cluster, client, port = dash
    sub_id = client.submit_job(entrypoint="echo one",
                               submission_id="fixed-id-1")
    client.wait_until_finished(sub_id, timeout=120)
    with pytest.raises(JobSubmissionError):
        client.submit_job(entrypoint="echo two", submission_id="fixed-id-1")


def test_cli_local_dump_and_global_gc(dash, tmp_path):
    """Ops commands (reference: scripts.py local_dump / global_gc)."""
    import io
    import tarfile
    from contextlib import redirect_stdout

    from ray_tpu.scripts import cli

    cluster, _client, _port = dash
    out = str(tmp_path / "dump.tar.gz")
    buf = io.StringIO()
    with redirect_stdout(buf):
        # Pin the dump to THIS cluster's session: mtime ordering over
        # /tmp is racy when other sessions churn concurrently.
        rc = cli.main(["local-dump", "--address", cluster.address,
                       "--out", out, "--session-dir",
                       cluster.session_dir])
    assert rc == 0
    with tarfile.open(out) as tar:
        names = tar.getnames()
    assert any("cluster_state.json" in n for n in names)
    assert any("logs" in n for n in names)

    with redirect_stdout(buf):
        rc = cli.main(["global-gc", "--address", cluster.address])
    assert rc == 0
    assert "gc.collect() ran" in buf.getvalue()
