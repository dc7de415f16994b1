"""The per-test time limit of conftest.py.

Each case runs a child pytest, under a timeout, on a throwaway test file
beside a copy of this directory's conftest.py, whose limit the throwaway
file lowers to 2 s.
"""

import os
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
LIMIT = 2
XDIST = ["-p", "xdist", "-n", "2"]

SLEEP = """
def test_stalls():
    STARTED.write_text(repr(time.time()))
    time.sleep(120)
"""

LOCK = """
def test_stalls():
    STARTED.write_text(repr(time.time()))
    lock = threading.Lock()
    lock.acquire()
    lock.acquire()
"""

# The limit covers a test's setup: a module fixture that stalls.
FIXTURE = """
@pytest.fixture(scope="module")
def stalled_fixture():
    STARTED.write_text(repr(time.time()))
    time.sleep(120)


def test_stalls(stalled_fixture):
    pass
"""

# Under xdist the other test still runs, on the other worker or on the
# one that replaces the worker the limit ended.
PASSES = """

def test_passes():
    pass
"""


@pytest.mark.parametrize("body,extra,stalled_in", [
    (SLEEP, [], "test_stalls"),
    (LOCK, [], "test_stalls"),
    (FIXTURE, [], "stalled_fixture"),
    (SLEEP + PASSES, XDIST, "test_stalls"),
    (LOCK + PASSES, XDIST, "test_stalls"),
], ids=["sleep", "deadlocked_lock", "stalled_module_fixture",
        "sleep_under_xdist", "deadlocked_lock_under_xdist"])
def test_a_stalled_test_fails_at_its_limit_with_its_stacks(
        tmp_path, body, extra, stalled_in):
    shutil.copy(os.path.join(HERE, "conftest.py"), tmp_path)
    started = tmp_path / "started"
    (tmp_path / "test_throwaway.py").write_text(
        f"import pathlib\nimport threading\nimport time\n\n"
        f"import conftest\nimport pytest\n\n"
        f"conftest.TIME_LIMIT_S = {LIMIT}\n"
        f"STARTED = pathlib.Path({str(started)!r})\n\n{body}")
    junit = tmp_path / "out.xml"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", f"--junitxml={junit}", *extra,
         "test_throwaway.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180)
    ended = time.time()
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    # faulthandler's dump: every thread's stack, the main thread's ending
    # in the function that stalled.
    assert f"Timeout (0:00:0{LIMIT})!" in run.stderr, out
    assert "most recent call first" in run.stderr, out
    assert 'test_throwaway.py", line' in run.stderr, out
    assert f"in {stalled_in}\n" in run.stderr, out
    if not extra:
        # The process ended at the limit, before pytest reported anything.
        assert ended - float(started.read_text()) <= LIMIT + 5, out
        assert not junit.exists(), out
        return
    cases = {c.get("name"): c for c in ET.parse(junit).getroot().iter(
        "testcase")}
    assert cases["test_passes"].find("failure") is None, out
    assert cases["test_passes"].find("error") is None, out
    crash = cases["test_stalls"].find("error")
    if crash is None:
        crash = cases["test_stalls"].find("failure")
    assert ("crashed while running 'test_throwaway.py::test_stalls'"
            in crash.get("message")), out
