"""The port's accuracy runbook, four-stream script and shift-op demo
(scripts/torch_*), and its crash-safe checkpoints, against the reference
package on the CPU.

- The demo (scripts/torch_demo_shift_op.py) against the reference demo
  (scripts/demo_shift_op.py) run with SGT_TSHIFT_IMPL=conv: on the ones
  tensor the raw position gradient is exactly 0 at some channels, which
  gives constraint_step's 1e-4 tie step; the reference's default dft
  lowering turns each tie into a signed ±0.01 step by its roundoff.
- A save cut off inside ``torch.save`` leaves no checkpoint under the
  final name, and ``resume: auto`` resumes from the previous one, as a
  cut-off Orbax save (a temporary directory) leaves the reference's
  ``latest_checkpoint`` at the previous step.
- The Trainer's resumed-past-the-end rerun writes the best-score pickle
  without retraining (the runbook's final-eval wedge).
- The runbook killed after its first stream and rerun (slow: eight
  training processes).
"""

import contextlib
import io
import os
import pickle
import re
import signal
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from shift_gcn_torch.train.config import ExperimentConfig
from shift_gcn_torch.train.trainer import Trainer
from shift_gcn_torch.utils import checkpoint as ckpt_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
STREAMS = ("joint", "bone", "joint_motion", "bone_motion")

# grad_ypos of the demo: the reference demo under SGT_TSHIFT_IMPL=conv
# and the port's plain path
DEMO_GRAD_YPOS = {1: [1e-4, 0.01, -0.01, -0.01, -0.01],
                  2: [0.01, 1e-4, 1e-4, -0.01, -0.01]}

# runs the reference demo script (argv[1]) with --cpu at strides 1 and 2
DEMO_MARK = "== reference demo ==\n"
REFERENCE_DEMOS = f"""
import runpy, sys
script = sys.argv[1]
for stride in ("1", "2"):
    print({DEMO_MARK!r}, end="", flush=True)
    sys.argv = [script, "--cpu", "--stride", stride]
    runpy.run_path(script, run_name="__main__")
"""

NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?")


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    # torch's oneDNN convolution backward corrupts the heap on the CPU once
    # the reference package's compiled XLA code has run in the same
    # process; torch's native convolution has the same arithmetic
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = saved


def _numbers(text: str) -> np.ndarray:
    return np.array([float(s) for s in NUMBER.findall(text)], np.float32)


def _parse_demo(text: str) -> dict:
    """The printed out[0, :, 0, :], grad_input norm, grad_xpos and
    grad_ypos of either demo."""
    lines = text.splitlines()
    start = lines.index("out[0, :, 0, :] =") + 1
    end = next(i for i, line in enumerate(lines)
               if line.startswith("grad_input norm:"))
    parsed = {"out": _numbers(" ".join(lines[start:end])),
              "norm": float(lines[end].split(":")[1])}
    for line in lines[end + 1:]:
        key = line.split(" ", 1)[0]
        if key in ("grad_xpos", "grad_ypos"):
            parsed[key] = _numbers(line[line.index("["):])
    return parsed


@pytest.fixture(scope="module")
def demos():
    """{stride: (reference demo's printed values, the port's printed
    values, the port's run_demo tensors)}, all on the CPU.  The reference
    demo runs as a script at both strides in one subprocess (one import
    of JAX), beside the port's runs in this process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", SGT_TSHIFT_IMPL="conv")
    env.pop("XLA_FLAGS", None)
    reference = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_DEMOS,
         os.path.join(SCRIPTS, "demo_shift_op.py")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    demo = chip_smoke.load_demo()
    ported = {}
    for s in (1, 2):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed), mock.patch.object(
                sys, "argv", ["torch_demo_shift_op.py", "--stride", str(s),
                              "--torch-device", "cpu"]):
            demo.main()
        ported[s] = (_parse_demo(printed.getvalue()), demo.run_demo(s, "cpu"))
    stdout, stderr = reference.communicate(timeout=120)
    assert reference.returncode == 0, stderr[-2000:]
    runs = stdout.split(DEMO_MARK)[1:]
    return {s: (_parse_demo(runs[i]),) + ported[s]
            for i, s in enumerate((1, 2))}


@pytest.mark.parametrize("stride", [1, 2])
def test_demo_grad_ypos_equals_the_reference_demos(demos, stride):
    ref, printed, tensors = demos[stride]
    want = np.array(DEMO_GRAD_YPOS[stride], np.float32)
    np.testing.assert_array_equal(ref["grad_ypos"], want)
    np.testing.assert_array_equal(printed["grad_ypos"], want)
    np.testing.assert_array_equal(tensors["grad_ypos"].numpy(), want)


@pytest.mark.parametrize("stride", [1, 2])
def test_demo_grad_xpos_is_zero(demos, stride):
    ref, printed, tensors = demos[stride]
    for got in (ref["grad_xpos"], printed["grad_xpos"],
                tensors["grad_xpos"].numpy()):
        np.testing.assert_array_equal(got, np.zeros(5, np.float32))


@pytest.mark.parametrize("stride", [1, 2])
def test_demo_output_and_input_gradient_match_the_reference(demos, stride):
    ref, printed, tensors = demos[stride]
    out = tensors["out"]
    assert tuple(out.shape) == (1, 8 // stride, 4, 5)
    np.testing.assert_allclose(out[0, :, 0, :].numpy().ravel(), ref["out"],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(printed["out"], ref["out"])
    norm = float(torch.linalg.vector_norm(tensors["grad_input"]))
    # the reference prints the norm to 4 decimals
    assert abs(norm - ref["norm"]) <= 1e-5 * ref["norm"] + 5e-5
    assert printed["norm"] == ref["norm"]


@pytest.mark.parametrize("script", ["torch_reproduce_accuracy.sh",
                                    "torch_train_all_streams.sh",
                                    "torch_demo_shift_op.py"])
def test_scripts_parse_and_name_only_the_port(script):
    path = os.path.join(SCRIPTS, script)
    text = open(path).read()
    assert "shift_gcn_tpu" not in text
    assert "shift_gcn_torch" in text
    if script.endswith(".sh"):
        subprocess.run(["bash", "-n", path], check=True)
        assert os.access(path, os.X_OK)


def _dataset(tmp_path):
    rng = np.random.default_rng(0)
    n = 16
    labels = rng.integers(0, 2, n)
    data = rng.standard_normal((n, 3, 16, 25, 1)).astype(np.float32)
    np.save(tmp_path / "data.npy", data)
    with open(tmp_path / "label.pkl", "wb") as f:
        pickle.dump(([f"s{i}" for i in range(n)], labels.tolist()), f)
    return {"data_path": str(tmp_path / "data.npy"),
            "label_path": str(tmp_path / "label.pkl")}


def _config(tmp_path, name, num_epoch):
    feeder = _dataset(tmp_path)
    return ExperimentConfig(
        Experiment_name=name,
        work_dir=str(tmp_path / "work"),
        model_saved_name=str(tmp_path / "save"),
        model_args={"num_class": 2, "num_point": 25, "num_person": 1,
                    "blocks": [[3, 8, 1, 0]]},
        train_feeder_args=feeder, test_feeder_args=feeder,
        batch_size=8, test_batch_size=8, num_epoch=num_epoch,
        eval_interval=1, save_interval=1, device_guard=False,
        resume="auto", print_log=False)


def test_resumed_past_end_run_still_writes_best_pickle(tmp_path):
    """The final-eval wedge: a kill after the last checkpoint save but
    during the final eval leaves a run whose auto-resume skips every
    epoch; Trainer.start() must still write eval_results/best_acc.pkl
    (re-evaluate, not retrain) or the runbook's ensemble stage fails on
    every rerun.  The reference package's test of the same name holds
    its Trainer to this."""
    tr = Trainer(_config(tmp_path, "wedge", 1), device="cpu")
    tr.train_epoch(0)
    tr.save(0)
    best_pkl = tmp_path / "work" / "wedge" / "eval_results" / "best_acc.pkl"
    assert not best_pkl.exists()

    tr2 = Trainer(_config(tmp_path, "wedge", 1), device="cpu")
    assert tr2.start_epoch == 1  # nothing left to train
    trained = []
    tr2.train_epoch = trained.append
    tr2.start()
    assert trained == []
    assert best_pkl.exists()
    with open(best_pkl, "rb") as f:
        assert len(pickle.load(f)) == 16


def _half_save(names):
    """A ``torch.save`` that writes half of its bytes, records the file's
    name and raises, as a process killed inside a save would stop."""
    real_save = torch.save

    def save(obj, f, *args, **kwargs):
        buf = io.BytesIO()
        real_save(obj, buf, *args, **kwargs)
        data = buf.getvalue()
        f.write(data[: len(data) // 2])
        names.append(f.name)
        raise OSError("save cut off")

    return save


def test_interrupted_save_leaves_no_checkpoint_and_resumes_the_previous(
        tmp_path, monkeypatch):
    tr = Trainer(_config(tmp_path, "cut", 2), device="cpu")
    tr.train_epoch(0)
    first = tr.save(0)
    step0 = tr.global_step
    tr.train_epoch(1)
    names = []
    with monkeypatch.context() as m:
        m.setattr(torch, "save", _half_save(names))
        with pytest.raises(OSError, match="save cut off"):
            tr.save(1)
    final = ckpt_lib.checkpoint_path(tr.save_dir, "cut", 1, tr.global_step)
    assert not os.path.exists(final)
    assert len(names) == 1 and not os.path.exists(names[0])
    assert os.listdir(tr.save_dir) == [os.path.basename(first)]
    assert ckpt_lib.latest_checkpoint(tr.save_dir) == first

    rerun = Trainer(_config(tmp_path, "cut", 2), device="cpu")
    assert rerun._resume_path == first
    assert (rerun.start_epoch, rerun.global_step) == (1, step0)


def test_leftover_temporary_file_is_ignored(tmp_path, monkeypatch):
    """A process killed inside a save leaves its temporary file behind;
    ``latest_checkpoint`` must not pick it, though it names a later
    epoch."""
    entry = {"model_state_dict": {"w": torch.ones(3)}}
    first = ckpt_lib.write_checkpoint(str(tmp_path), "exp", 0, 4, 0.5,
                                      entry)
    names = []
    with monkeypatch.context() as m:
        m.setattr(torch, "save", _half_save(names))
        with pytest.raises(OSError):
            ckpt_lib.write_checkpoint(str(tmp_path), "exp", 1, 8, 0.5, entry)
    # what a kill (no cleanup) leaves: the half-written temporary file
    blob = io.BytesIO()
    torch.save(dict(entry, epoch=1, global_step=8, best_acc=0.5), blob)
    with open(names[0], "wb") as f:
        f.write(blob.getvalue()[: len(blob.getvalue()) // 2])
    leftover = os.path.basename(names[0])
    assert leftover.startswith(".exp-1-8.pt.") and leftover.endswith(".tmp")
    assert not ckpt_lib._CHECKPOINT_NAME.fullmatch(leftover)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(first), leftover])
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) == first
    _, meta = ckpt_lib.load_reference_checkpoint(first)
    assert meta == {"epoch": 0, "global_step": 4, "best_acc": 0.5}


def test_reference_latest_checkpoint_ignores_orbax_temporary_dirs(tmp_path):
    """The reference behaviour the repair matches: Orbax writes a step to
    a temporary directory and renames it on commit, so a cut-off save
    leaves ``<step>.orbax-checkpoint-tmp-<n>``, which the reference's
    ``latest_checkpoint`` passes over."""
    from shift_gcn_tpu.utils.checkpoint import latest_checkpoint

    (tmp_path / "2").mkdir()
    (tmp_path / "3.orbax-checkpoint-tmp-1").mkdir()
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "2")


# tiny 2-block model + small batch so both invocations stay CPU-cheap;
# '|'-delimited because --model_args carries a YAML dict with spaces
TINY_ARGS = "|".join([
    "--model_args",
    "{num_class: 2, num_point: 33, num_person: 1, graph: mediapipe_pose,"
    " blocks: [[3, 8, 1, 0], [8, 8, 1, 1]]}",
    "--batch_size", "8", "--test_batch_size", "8",
    "--activation_dtype", "float32",
    "--torch-device", "cpu",
])


@pytest.mark.slow
def test_runbook_kill_after_stream1_then_rerun_resumes(tmp_path):
    """scripts/torch_reproduce_accuracy.sh killed once the joint stream's
    final checkpoint exists and the bone stream has started, then rerun:
    the data stages skip, the joint stream resumes past its end with no
    epoch retrained, and the chain finishes to the table (the port's
    counterpart of tests/test_runbook_resume.py's test of the same
    name)."""
    env = dict(os.environ)
    env.update({"DATA_DIR": str(tmp_path / "data"),
                "WORK_DIR": str(tmp_path / "work"), "EPOCHS": "2",
                "N_TRAIN": "16", "N_VAL": "16",
                "EXTRA_TRAIN_ARGS": TINY_ARGS})
    script = os.path.join(SCRIPTS, "torch_reproduce_accuracy.sh")
    joint_saves = tmp_path / "work" / "save_models" / \
        "mediapipe_ShiftGCN_joint"
    bone_log = tmp_path / "work" / "mediapipe_ShiftGCN_bone" / "log.txt"

    def joint_final():
        return list(joint_saves.glob("mediapipe_ShiftGCN_joint-1-*.pt"))

    proc = subprocess.Popen(
        ["bash", script], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        deadline = time.time() + 600
        while time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError("runbook exited before the kill "
                                     f"point:\n{proc.stdout.read()[-3000:]}")
            if joint_final() and bone_log.exists():
                break
            time.sleep(0.5)
        else:
            raise AssertionError("joint checkpoint / bone start never "
                                 "appeared within 600 s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.stdout.close()
        proc.wait()
    assert joint_final()

    out = subprocess.run(["bash", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    assert "skipping gendata" in out.stdout
    assert "stage 2: modality artifacts already present" in out.stdout
    assert "metrics vs BASELINE.md" in out.stdout

    joint_log = (tmp_path / "work" / "mediapipe_ShiftGCN_joint"
                 / "log.txt").read_text()
    assert "Auto-resume found checkpoint" in joint_log
    assert "Resumed: epoch=2" in joint_log  # == num_epoch: nothing retrained
    post_resume = joint_log.split("Auto-resume found checkpoint")[-1]
    assert "Training epoch:" not in post_resume
    for stream in STREAMS:
        work = tmp_path / "work" / f"mediapipe_ShiftGCN_{stream}"
        assert (work / "eval_results" / "best_acc.pkl").exists(), stream
        assert "Device: cpu" in (work / "log.txt").read_text(), stream
