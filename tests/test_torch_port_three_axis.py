"""The (data, model, pipe) composition in the torch port — the pipelined
ViT's blocks over the pipe axis, its ArcFace margin class-sharded over
the model axis (the partial-FC CE), the batch over the data axis —
against the JAX package's (2, 2, 2) mesh (tests/test_three_axis_pipeline.py,
tests/test_three_axis_trainer_e2e.py), over four gloo ranks at (1, 2, 2)
(tests/torch_port_pipeline_worker.py, started once for the module).

Tolerances: the three `arcface --sharded_ce` steps at the port's step
parity tolerance (atol 1e-5 / rtol 1e-4, JAX in f64): every metric
(the losses among them) and every parameter after each step; the
labels=None scores within 1e-5 of JAX's dense `ArcMarginHead` on the
model's own embedding. The CLI (`torchrun`'s environment, four gloo
ranks) trains, evaluates, saves and resumes; a Trainer resumed from its
run dir holds this rank's stage blocks and margin shard, which are the
file's, and trains on; the file (written at pipe 2) loads into a
one-process state (pipe 1) with the same tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.models.heads import ArcMarginHead
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.models import vit as port_vit
from ddp_classification_pytorch_tpu_torch.parallel import mesh as port_mesh
from ddp_classification_pytorch_tpu_torch.train import checkpoint
from ddp_classification_pytorch_tpu_torch.train.state import create_train_state

import torch_port_heads as H
import torch_port_model_axis as MA
import torch_port_pipeline as PP
from torch_port_threads import one_torch_thread  # noqa: F401

METRICS = ("loss", "grad_norm", "top1", "top3", "step_ok")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return PP.ranks(tmp_path_factory, "three")


def _jax_arc_steps(mesh, mp, pp):
    cfg = PP.jax_cfg("arcface", mp=mp, pp=pp, sharded_ce=mp > 1,
                     image=PP.IMAGE, classes=PP.CLASSES, batch=PP.BATCH)
    cfg.model.arc_easy_margin = True
    with jax.enable_x64(True):
        jmodel = PP.jax_model(cfg, mesh)
    with PP.patched_vit():
        return MA.jax_steps_run(
            cfg, jmodel, mesh, PP.jax_params("arcface", PP.IMAGE,
                                             PP.CLASSES), {},
            PP.arc_batches(500))


def test_dp_tp_pp_arcface_steps_match_jax(run):
    """Three `arcface --sharded_ce` steps at (1, 2, 2) against JAX's on
    its (2, 2, 2) mesh: losses, metrics and every parameter."""
    ranks, _, _ = run
    want = _jax_arc_steps(PP.jax_mesh(2, 2, 2), 2, 2)
    got = ranks[0]["arc"]
    assert len(got) == len(want) == 3
    for (gm, gstate), (wm, wparams, _) in zip(got, want):
        for key in METRICS:
            np.testing.assert_allclose(gm[key], wm[key], err_msg=key,
                                       **H.TOL)
        expect = PP.port_sd(wparams, "arcface")
        assert sorted(gstate) == sorted(expect)
        for k, w in expect.items():
            np.testing.assert_allclose(gstate[k].numpy(), np.asarray(w),
                                       err_msg=k, **H.TOL)
    assert all(np.isfinite(m["loss"]) for m, _ in got)


def test_arcface_scores_match_the_dense_head(run):
    """labels=None through the pipelined backbone and the class-sharded
    margin: JAX's dense ArcMarginHead s·cosθ on the model's embedding,
    on every rank."""
    ranks, _, _ = run
    margin = PP.jax_params("arcface", PP.IMAGE, PP.CLASSES)["margin"]
    for r in range(4):
        scores, emb = ranks[r]["scores"]
        head = ArcMarginHead(num_classes=PP.CLASSES,
                             in_features=emb.shape[1])
        want = head.apply({"params": margin}, jnp.asarray(emb.numpy()), None)
        assert scores.shape == (PP.BATCH, PP.CLASSES)
        np.testing.assert_allclose(scores.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_ranks_sit_on_the_three_axis_mesh(run):
    """rank = (d·mp + m)·pp + p: at (1, 2, 2) rank r is model r // 2,
    pipe r % 2."""
    ranks, _, _ = run
    for r in range(4):
        assert ranks[r]["coords"] == (r // 2, r % 2)


def test_cli_trains_evaluates_saves_and_resumes(run):
    """The CLI at (1, 2, 2): an epoch with its eval and checkpoint, then
    `--auto_resume --epochs 2` continues from it; every rank exits 0."""
    ranks, logs, tmp = run
    for r in range(4):
        assert ranks[r]["cli"] == [0, 0], logs[r]
    assert "mesh={'data': 1, 'model': 2, 'pipe': 2}" in logs[0]
    assert "auto-resumed from" in logs[0]
    for e in (0, 1):
        path = str(tmp / "run" / f"ckpt_e{e}.pt")
        assert checkpoint.verify(path) is None


def test_resumed_shards_sit_on_their_groups_and_train(run):
    """A Trainer over the run dir restores epoch 1's file: each rank holds
    its stage's blocks and its model shard of the margin, both the file's
    tensors, and one more epoch trains (finite loss, the step advances,
    the sharded-CE eval finite)."""
    ranks, _, tmp = run
    whole = torch.load(str(tmp / "run" / "ckpt_e1.pt"), weights_only=True)
    w = whole["model"]["margin.weight"]
    for r in range(4):
        res = ranks[r]["resume"]
        m, p = r // 2, r % 2
        assert res["start_epoch"] == 2
        assert res["mesh"] == {"data": 1, "model": 2, "pipe": 2}
        assert res["blocks"] == [str(2 * p), str(2 * p + 1)]
        torch.testing.assert_close(res["margin"], w.chunk(2)[m], rtol=0,
                                   atol=0)
        torch.testing.assert_close(res["patch"],
                                   whole["model"]["backbone.patch.weight"],
                                   rtol=0, atol=0)
        assert res["step"] == whole["step"] and res["after"] > res["step"]
        assert np.isfinite(res["loss"])
        assert np.isfinite(res["eval"]["val_loss"])


def test_checkpoint_at_pipe_2_resumes_at_pipe_1(run):
    """The file (all 4 blocks, the one-rank format) loads into a
    one-process train state, where the pipeline is one stage: the same
    tensors and optimizer state."""
    ranks, _, tmp = run
    whole = torch.load(str(tmp / "run" / "ckpt_e1.pt"), weights_only=True)
    assert {k.split(".")[2] for k in whole["model"]
            if k.startswith("backbone.blocks.")} == {"0", "1", "2", "3"}
    cfg = get_preset("arcface")
    cfg.model.arch, cfg.model.dtype = "vit_t16", "float32"
    cfg.data.image_size, cfg.data.num_classes = PP.IMAGE, PP.CLASSES
    cfg.parallel.pipeline_microbatches = 2
    kept = port_vit.VIT_CONFIGS["vit_t16"]
    port_vit.VIT_CONFIGS["vit_t16"] = PP.PIPE_VIT
    try:
        state = create_train_state(cfg, torch.device("cpu"), 4,
                                   mesh=port_mesh.Mesh())
    finally:
        port_vit.VIT_CONFIGS["vit_t16"] = kept
    state.load_state_dict(whole)
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, whole["model"][k], rtol=0, atol=0)
    got = state.state_dict()["optimizer"]
    assert got["state"].keys() == whole["optimizer"]["state"].keys()
    for i, st in got["state"].items():
        for key, t in st.items():
            torch.testing.assert_close(
                t, whole["optimizer"]["state"][i][key], rtol=0, atol=0)
    assert state.step == whole["step"]
