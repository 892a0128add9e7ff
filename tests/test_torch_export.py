"""Port serving artifacts (shift_gcn_torch.inference.export / serve) on the
CPU: torch.export artifacts reproduce the live eval forward and the
reference package's exported artifact on the same weights, hold the two
kernels as registered operators (one node per launch), and refuse what
they must refuse."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shift_gcn_tpu.inference import export as jax_export
from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_torch.inference import export, serve
from shift_gcn_torch.models.shift_gcn import (
    Model, config_from_reference_args)
from shift_gcn_torch.ops import library, shift_gcn_kernel, temporal_shift
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

ARGS = {"num_class": 2, "num_point": 25, "num_person": 1,
        "graph": "ntu_rgb_d", "blocks": [[3, 8, 1, False], [8, 16, 2]]}
T = 16


def _arrays(args, seed):
    """The reference package's init, with non-trivial eval BN statistics:
    (params, bn_state) as numpy trees."""
    cfg = jax_model.config_from_reference_args(args)
    params, state = jax_model.init_params(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map(np.array, params)
    state = jax.tree_util.tree_map(np.array, state)
    rng = np.random.default_rng(seed)
    for block in state:
        if block.startswith("l"):
            bn = state[block]["tcn1"]["bn2"]
            bn["running_mean"] = rng.normal(
                0, 0.3, bn["running_mean"].shape).astype(np.float32)
            bn["running_var"] = rng.uniform(
                0.5, 1.5, bn["running_var"].shape).astype(np.float32)
    return params, state


def _state_dict(args=ARGS, seed=0):
    return state_dict_from_arrays(*_arrays(args, seed))


def _live(state_dict, x, args=ARGS):
    model = Model(config_from_reference_args(args), device="cpu")
    model.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        return model(torch.as_tensor(x)).numpy()


def _clips(n, seed, v=25, m=1):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, T, v, m)).astype(np.float32)


def _save_run_dir(path, state_dict):
    """A port trainer run dir: <dir>/<experiment>-<epoch>-<step>.pt."""
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"model_state_dict": state_dict, "epoch": 3,
                "global_step": 30, "best_acc": 0.5},
               path / "fall_joint-3-30.pt")
    return str(path)


def test_baked_export_roundtrip_matches_live_forward():
    cfg = config_from_reference_args(ARGS)
    sd = _state_dict()
    x = _clips(4, 0)
    blob = export.export_eval_baked(sd, cfg, batch_size=4, seq_len=T,
                                    device="cpu")
    assert isinstance(blob, bytes) and len(blob) > 0
    art = export.load_exported(blob)
    with torch.no_grad():
        got = art.module()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _live(sd, x), atol=1e-5)


def test_weights_as_inputs_export_hot_swaps_checkpoints():
    cfg = config_from_reference_args(ARGS)
    sd1, sd2 = _state_dict(seed=1), _state_dict(seed=2)
    x = _clips(2, 1)
    art = export.load_exported(export.export_eval(
        sd1, cfg, batch_size=2, seq_len=T, device="cpu"))
    for sd in (sd1, sd2):
        got = serve.score_clips(art, x, 2, weights=sd, device="cpu")
        np.testing.assert_allclose(got, _live(sd, x), atol=1e-5)


def test_artifact_matches_reference_export():
    """The port's artifacts and the reference package's export_eval
    artifact, on the same weights and clips, within 1e-5."""
    params, state = _arrays(ARGS, 5)
    sd = state_dict_from_arrays(params, state)
    cfg = config_from_reference_args(ARGS)
    x = _clips(5, 5)
    ref = jax_export.load_exported(jax_export.export_eval(
        params, state, jax_model.config_from_reference_args(ARGS), 5, T))
    want = np.asarray(ref.call(params, state, jnp.asarray(x)))
    art = export.load_exported(export.export_eval(sd, cfg, 5, T,
                                                  device="cpu"))
    baked = export.load_exported(export.export_eval_baked(sd, cfg, 5, T,
                                                          device="cpu"))
    np.testing.assert_allclose(
        serve.score_clips(art, x, 5, weights=sd, device="cpu"), want,
        atol=1e-5)
    np.testing.assert_allclose(
        serve.score_clips(baked, x, 5, device="cpu"), want, atol=1e-5)


def test_serve_cli_scores_clips(tmp_path):
    """export -> serve: batch scoring (a padded tail included) matches the
    live forward."""
    cfg = config_from_reference_args(ARGS)
    sd = _state_dict(seed=4)
    art_path = tmp_path / "model.pt2"
    art_path.write_bytes(export.export_eval_baked(sd, cfg, 4, T,
                                                  device="cpu"))
    data = _clips(10, 3)
    np.save(tmp_path / "clips.npy", data)
    serve.main(["--artifact", str(art_path),
                "--data", str(tmp_path / "clips.npy"),
                "--out", str(tmp_path / "scores.npy"),
                "--batch-size", "4", "--device", "cpu"])
    got = np.load(tmp_path / "scores.npy")
    assert got.shape == (10, 2)
    np.testing.assert_allclose(got, _live(sd, data), atol=1e-5)


def test_export_checkpoint_cli_path(tmp_path):
    """export_checkpoint reads a run dir and writes either flavour."""
    cfg = config_from_reference_args(ARGS)
    sd = _state_dict(seed=3)
    save_dir = _save_run_dir(tmp_path / "save", sd)
    x = _clips(2, 2)
    want = _live(sd, x)
    out = export.export_checkpoint(
        save_dir, str(tmp_path / "model.pt2"), config=cfg, batch_size=2,
        seq_len=T, device="cpu")
    art = export.load_exported(out)
    # default flavour takes the weights as inputs
    assert not serve.artifact_is_baked(art)
    np.testing.assert_allclose(
        serve.score_clips(art, x, 2, weights=sd, device="cpu"), want,
        atol=1e-5)
    out_b = export.export_checkpoint(
        save_dir, str(tmp_path / "model_baked.pt2"), config=cfg,
        batch_size=2, seq_len=T, baked=True, device="cpu")
    art_b = export.load_exported(out_b)
    np.testing.assert_allclose(serve.score_clips(art_b, x, 2, device="cpu"),
                               want, atol=1e-5)


def test_export_and_serve_cli_full_width_model(tmp_path, capsys):
    """The two CLIs on the full-width MediaPipe fall model (10 units, at
    T=16): export a weights-as-inputs artifact, serve it with --weights."""
    cfg = export.default_config()
    model = Model(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    ckpt = tmp_path / "fall_joint-1-10.pt"
    torch.save(model.state_dict(), ckpt)
    art = tmp_path / "fall.pt2"
    export.main(["--checkpoint", str(ckpt), "--out", str(art),
                 "--batch-size", "2", "--seq-len", str(T),
                 "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    data = _clips(3, 6, v=33)
    np.save(tmp_path / "clips.npy", data)
    serve.main(["--artifact", str(art), "--data", str(tmp_path / "clips.npy"),
                "--out", str(tmp_path / "scores.npy"), "--batch-size", "2",
                "--weights", str(ckpt), "--device", "cpu"])
    with torch.no_grad():
        want = model(torch.from_numpy(data)).numpy()
    np.testing.assert_allclose(np.load(tmp_path / "scores.npy"), want,
                               atol=1e-5)


def test_serve_inputs_flavor_and_baked_detection():
    cfg = config_from_reference_args(ARGS)
    sd = _state_dict()
    data = _clips(5, 0)
    art_i = export.load_exported(export.export_eval(sd, cfg, 2, T,
                                                    device="cpu"))
    art_b = export.load_exported(export.export_eval_baked(sd, cfg, 2, T,
                                                          device="cpu"))
    assert not serve.artifact_is_baked(art_i)
    assert serve.artifact_is_baked(art_b)
    got_i = serve.score_clips(art_i, data, 2, weights=sd, device="cpu")
    got_b = serve.score_clips(art_b, data, 2, device="cpu")
    assert got_i.shape == (5, 2)
    np.testing.assert_allclose(got_i, got_b, atol=1e-5)
    with pytest.raises(ValueError, match="takes no weights"):
        serve.score_clips(art_b, data, 2, weights=sd, device="cpu")
    with pytest.raises(ValueError, match="needs them"):
        serve.score_clips(art_i, data, 2, device="cpu")


def test_restore_weights_for_artifact_any_architecture(tmp_path):
    """Weights for a weights-as-inputs artifact are restored with the
    artifact's own inputs as the template: no model config needed, so a
    non-default architecture round-trips through score_clips; weights of
    another architecture raise."""
    args = {"num_class": 5, "num_point": 25, "num_person": 2,
            "graph": "ntu_rgb_d", "blocks": [[3, 8, 1, False], [8, 16, 2]]}
    sd = _state_dict(args, seed=7)
    save_dir = _save_run_dir(tmp_path / "save", sd)
    cfg = config_from_reference_args(args)
    art = export.load_exported(export.export_eval(sd, cfg, 2, T,
                                                  device="cpu"))
    weights = export.restore_weights_for_artifact(save_dir, art)
    assert list(weights) == list(export.weight_specs(art))
    data = _clips(3, 3, m=2)
    got = serve.score_clips(art, data, 2, weights=weights, device="cpu")
    np.testing.assert_allclose(got, _live(sd, data, args), atol=1e-5)

    other = _save_run_dir(tmp_path / "other", _state_dict(ARGS, seed=7))
    with pytest.raises(ValueError, match="shape|missing"):
        export.restore_weights_for_artifact(other, art)
    # baked artifacts refuse the weights path loudly
    baked = export.load_exported(export.export_eval_baked(
        sd, cfg, 2, T, device="cpu"))
    with pytest.raises(ValueError, match="baked"):
        export.restore_weights_for_artifact(save_dir, baked)


def test_hot_swapped_weight_at_shift_limit_raises(tmp_path):
    """Weights that reach an artifact without load_state_dict get its
    shift range check: a ypos at max_shift - 0.5 raises in score_clips,
    in restore_weights_for_artifact and in export_eval."""
    cfg = config_from_reference_args(ARGS)
    sd = _state_dict()
    art = export.load_exported(export.export_eval(sd, cfg, 2, T,
                                                  device="cpu"))
    bad = dict(sd)
    ypos = bad["l2.tcn1.shift_out.ypos"].clone()
    ypos[0] = 7.5
    bad["l2.tcn1.shift_out.ypos"] = ypos
    with pytest.raises(ValueError, match="max_shift"):
        serve.score_clips(art, _clips(2, 0), 2, weights=bad, device="cpu")
    with pytest.raises(ValueError, match="max_shift"):
        export.restore_weights_for_artifact(
            _save_run_dir(tmp_path / "bad", bad), art)
    with pytest.raises(ValueError, match="max_shift"):
        export.export_eval(bad, cfg, 2, T, device="cpu")


def _counted(monkeypatch):
    """Count the forward launchers' calls (one per kernel launch on the
    card; the plain version here)."""
    calls = {"temporal_shift": 0, "shift_gcn": 0}

    def wrap(module, name, key):
        inner = getattr(module, name)

        def counted(*args):
            calls[key] += 1
            return inner(*args)

        monkeypatch.setattr(module, name, counted)

    wrap(temporal_shift, "temporal_shift_forward", "temporal_shift")
    wrap(shift_gcn_kernel, "shift_gcn_forward", "shift_gcn")
    return calls


@pytest.mark.parametrize("baked", [False, True], ids=["inputs", "baked"])
def test_exported_graph_holds_one_op_node_per_launch(monkeypatch, baked):
    """The artifact's graph names K1 and K4 as the registered operators,
    one node per launch of the live module (2 and 1 per unit), and holds
    no plain-version decomposition of them; exporting launches nothing,
    and running the artifact launches what the live module does."""
    cfg = config_from_reference_args(ARGS)
    units = len(cfg.blocks)
    sd = _state_dict()
    calls = _counted(monkeypatch)
    exporter = export.export_eval_baked if baked else export.export_eval
    art = export.load_exported(exporter(sd, cfg, 2, T, device="cpu"))
    assert calls == {"temporal_shift": 0, "shift_gcn": 0}
    targets = [n.target for n in art.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.shift_gcn_torch.temporal_shift.default
                         ) == 2 * units
    assert targets.count(torch.ops.shift_gcn_torch.shift_gcn.default
                         ) == units
    names = {str(t) for t in targets}
    # the plain versions gather frames and joints and floor the shifts
    assert not names & {"aten.gather.default", "aten.floor.default"}
    x = _clips(2, 1)
    _live(sd, x)
    assert calls == {"temporal_shift": 2 * units, "shift_gcn": units}
    serve.score_clips(art, x, 2, weights=None if baked else sd,
                      device="cpu")
    assert calls == {"temporal_shift": 4 * units, "shift_gcn": 2 * units}


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_opcheck_temporal_shift(stride, dtype):
    rng = np.random.default_rng(stride)
    x = torch.from_numpy(rng.standard_normal((2, 9, 5, 6)).astype(
        np.float32)).to(dtype)
    ypos = torch.from_numpy(rng.uniform(-2, 2, 6).astype(np.float32))
    torch.library.opcheck(library.temporal_shift, (x, ypos, stride))
    out = library.temporal_shift(x, ypos, stride)
    assert out.shape == (2, 9 // stride, 5, 6) and out.dtype == dtype
    assert torch.equal(out, temporal_shift.temporal_shift_reference(
        x, ypos, stride))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_opcheck_shift_gcn(dtype):
    from shift_gcn_torch.ops.spatial_shift import shift_gcn_transform

    rng = np.random.default_rng(0)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    x, gate, w, b = arr(12, 5, 4).to(dtype), arr(5, 4), arr(4, 3), arr(3)
    torch.library.opcheck(library.shift_gcn, (x, gate, w, b))
    out = library.shift_gcn(x, gate, w, b)
    assert out.shape == (12, 5, 3) and out.dtype == dtype
    assert torch.equal(out, shift_gcn_transform(x, gate, w, b))


def test_ops_without_autograd_raise_on_backward():
    """Called where autograd records them, the ops' backward raises: they
    never cut a gradient silently (training goes through the Functions)."""
    x = torch.randn(1, 4, 3, 2)
    ypos = torch.zeros(2, requires_grad=True)
    out = library.temporal_shift(x, ypos, 1)
    with pytest.raises(RuntimeError, match="autograd"):
        out.sum().backward()


def test_artifact_refuses_other_device():
    cfg = config_from_reference_args(ARGS)
    art = export.load_exported(export.export_eval_baked(
        _state_dict(), cfg, 2, T, device="cpu"))
    assert export.artifact_device(art) == torch.device("cpu")
    with pytest.raises(ValueError, match="exported for cpu"):
        export.check_artifact_device(art, torch.device("cuda", 0))
    export.check_artifact_device(art, torch.device("cpu"))


def test_serve_and_export_need_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    cfg = config_from_reference_args(ARGS)
    sd = _state_dict()
    art = export.load_exported(export.export_eval_baked(sd, cfg, 2, T,
                                                        device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.score_clips(art, _clips(2, 0), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.export_eval(sd, cfg, 2, T)
