"""The port's training and eval entries on two gloo ranks, on the CPU.

One 2-rank job (``test_torch_port_dist.run_ranks``: spawned processes, one
thread each, ``file://`` init, every wait bounded and the ranks killed on
expiry) runs the training entry of ``test_torch_port_entry.entry_cfg``
(mini-2x at 64/96 px on a synthetic COCO set, 2 images a rank, DropBlock
off) as ``tests/test_multihost.py`` runs the JAX entry on two processes,
and writes what each rank saw to npz.  Held:

* each rank reads a disjoint shard of the records, together all of them;
* only rank 0 writes npz files and ``metrics.jsonl`` (one row per logged
  step, the losses averaged over the ranks), and rank 0's periodic eval
  runs while rank 1 waits;
* the final params, momentum and EMA are bitwise equal on both ranks; the
  BN running statistics are each rank's own (``norm_type='bn'``, as each
  JAX replica keeps them);
* 2 steps, a ``resume_state`` and 2 more equal 4 steps bitwise on rank 0;
  rank 1 differs in its BN running statistics only, which restart from
  rank 0's saved ones (as JAX restores device 0's values on every device)
  and never enter a train-mode forward;
* ``ckpt_backend='orbax'`` (``checkpoint/dcp_io.py``): every rank saves,
  ``latest_step`` reads 2, a second run resumes to step 4, equal to the
  straight run as the npz resume is;
* ``run_eval`` under the group (``coco_eval(distributed=True)``): rank 0's
  12 stats and merged detections equal one process's eval of the same
  weights, every image's shard written once, rank 1 returns None; a
  rank-0-gated ``coco_eval(distributed=False)`` evaluates the whole set
  while rank 1 waits at a barrier (no deadlock).
"""
import json
import os
import pickle

import numpy as np
import pytest

from ppyolo_tpu_torch.data.coco import CocoJson, category_maps, data_clean
from ppyolo_tpu_torch.entry import eval as eval_entry

from test_torch_port_dist import load_ranks, run_ranks, wait_ranks
from test_torch_port_entry import dataset, entry_cfg  # noqa: F401 (the fixture)

_WORKER = r'''
import os, pickle, sys
rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as tdist
import ppyolo_tpu_torch.checkpoint.io as ckpt_io
import ppyolo_tpu_torch.entry.train as train_entry
from ppyolo_tpu_torch.checkpoint.dcp_io import DCPCheckpointer
from ppyolo_tpu_torch.data.coco import CocoJson
from ppyolo_tpu_torch.entry.eval import run_eval
from ppyolo_tpu_torch.eval.coco_eval import clsid_to_catid, coco_eval
from ppyolo_tpu_torch.eval.detector import Detector
from ppyolo_tpu_torch.models import PPYOLO
from ppyolo_tpu_torch.parallel import dist

cfgs = pickle.load(open(os.path.join(tmp, "cfgs.pkl"), "rb"))
out = {}
written, shard_ids = [], []
write = ckpt_io._write_npz_atomic
ckpt_io._write_npz_atomic = lambda path, flat: (written.append(os.path.basename(path)),
                                                write(path, flat))[1]
batches = train_entry.train_batches


def recording_batches(records, cfg, **kw):
    shard_ids.extend(int(r["im_id"][0]) for r in records[kw["shard_id"]::kw["num_shards"]])
    return batches(records, cfg, **kw)


train_entry.train_batches = recording_batches


def same_on_all_ranks(tensors):
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    ref = flat.clone()
    tdist.broadcast(ref, 0)
    ok = torch.tensor([float(torch.equal(ref, flat))])
    tdist.all_reduce(ok, op=tdist.ReduceOp.MIN)
    return bool(ok.item())


def snapshot(state):
    return {k: v.clone() for k, v in state.tensors().items()}


def differ(state, want):
    return np.array([k for k, v in state.tensors().items() if not torch.equal(v, want[k])],
                    dtype=str)


def train(name, **kw):
    return train_entry.run_training(cfgs[name], device="cpu", ndev=world, **kw)


dist.init_from_env("cpu", init_method=init)
w = lambda name: os.path.join(tmp, name)

state = train("straight", weights_dir=w("straight"))
straight = snapshot(state)
out["straight/step"] = state.step
out["straight/replicas_equal"] = same_on_all_ranks(
    [v for k, v in state.tensors().items() if "running_" not in k])
out["straight/running_equal"] = same_on_all_ranks(
    [v for k, v in state.tensors().items() if "running_" in k])
out["straight/written"] = np.array(written, dtype=object).astype(str)
out["straight/shard_ids"] = np.array(shard_ids)

train("first_half", weights_dir=w("resumed"))
state = train("second_half", weights_dir=w("resumed"))
out["resume/step"] = state.step
out["resume/differ"] = differ(state, straight)

train("dcp_half", weights_dir=w("dcp"))
ck = DCPCheckpointer(os.path.join(w("dcp"), "dcp"))
out["dcp/latest_after_half"] = ck.latest_step()
state = train("dcp_full", weights_dir=w("dcp"))
out["dcp/step"] = state.step
out["dcp/steps"] = np.array(ck.steps())
out["dcp/differ"] = differ(state, straight)
out["all/written_by_rank"] = np.array(written, dtype=object).astype(str)

stats = run_eval(cfgs["eval"], device="cpu", result_dir=w("eval_dist"))
out["eval/is_none"] = stats is None
if stats is not None:
    out["eval/stats"] = stats
    out["eval/shards"] = np.array(sorted(os.listdir(os.path.join(w("eval_dist"), "bbox"))))

if rank == 0:   # train.py's gated periodic eval: rank 1 does not take part
    cfg = cfgs["eval"]
    val = CocoJson(cfg.val_path)
    images = [im for im in val.dataset["images"] if val.img_anns.get(im["id"])]
    model = PPYOLO.from_config(cfg)
    det = Detector(model, model.state_dict(), cfg, target_size=64, device="cpu")
    gated = coco_eval(det, images, cfg.val_pre_path, cfg.val_path, 2,
                      result_dir=w("eval_gated"), clsid2catid=clsid_to_catid(cfg, val),
                      distributed=False)
    out["gated/stats"] = gated
    out["gated/shards"] = len(os.listdir(os.path.join(w("eval_gated"), "bbox")))
    out["gated/images"] = len(images)
dist.barrier()

np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
tdist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(dataset, tmp_path_factory):  # noqa: F811
    tmp = str(tmp_path_factory.mktemp("dist_entry"))
    no_eval = dict(eval_iter=10 ** 9)
    straight = os.path.join(tmp, "straight")
    cfgs = {"straight": entry_cfg(dataset),
            "first_half": entry_cfg(dataset, max_iters=2, **no_eval),
            "second_half": entry_cfg(dataset, resume_state=os.path.join(
                tmp, "resumed", "last_state.npz"), **no_eval),
            "dcp_half": entry_cfg(dataset, max_iters=2, ckpt_backend="orbax", **no_eval),
            "dcp_full": entry_cfg(dataset, ckpt_backend="orbax", **no_eval),
            "eval": entry_cfg(dataset)}
    cfgs["eval"].eval_cfg = dict(cfgs["eval"].eval_cfg, draw_image=False,
                                 model_path=os.path.join(straight, "step00000004.npz"))
    with open(os.path.join(tmp, "cfgs.pkl"), "wb") as f:
        pickle.dump(cfgs, f)
    handle = run_ranks(_WORKER, tmp, tmp)
    wait_ranks(handle, tmp)
    return dict(tmp=tmp, cfgs=cfgs, ranks=load_ranks(tmp))


def test_ranks_read_disjoint_record_shards(ranks, dataset):  # noqa: F811
    cfg = ranks["cfgs"]["straight"]
    coco = CocoJson(cfg.train_path)
    records = data_clean(coco, coco.get_img_ids(), category_maps(coco)[0], cfg.train_pre_path)
    ids = [set(r["straight/shard_ids"].tolist()) for r in ranks["ranks"]]
    assert ids[0] and ids[1] and not ids[0] & ids[1]
    assert ids[0] | ids[1] == {int(r["im_id"][0]) for r in records}


def test_only_rank_0_writes_npz_files_and_metrics(ranks):
    r0, r1 = ranks["ranks"]
    assert r1["all/written_by_rank"].size == 0
    assert {"step00000002.npz", "step00000004.npz", "last_state.npz",
            "best_model.npz"} <= set(r0["straight/written"].tolist())
    rows = [json.loads(line)
            for line in open(os.path.join(ranks["tmp"], "straight", "metrics.jsonl"))]
    assert [r["iter"] for r in rows if "total_loss" in r] == [1, 2, 3, 4]
    evals = [r for r in rows if "box_ap" in r]
    assert len(evals) == 1 and evals[0]["iter"] == 4 and len(evals[0]["stats"]) == 12


def test_replicas_end_bitwise_equal(ranks):
    for r in ranks["ranks"]:
        assert int(r["straight/step"]) == 4 and bool(r["straight/replicas_equal"])
        assert not bool(r["straight/running_equal"])


def _only_rank_1_running_stats(ranks, key):
    r0, r1 = ranks["ranks"]
    assert r0[key].size == 0, r0[key][:5]
    assert r1[key].size and all("running_" in k for k in r1[key].tolist())


def test_two_rank_resume_is_bitwise_the_straight_run(ranks):
    assert all(int(r["resume/step"]) == 4 for r in ranks["ranks"])
    _only_rank_1_running_stats(ranks, "resume/differ")


def test_dcp_checkpoints_save_on_every_rank_and_resume(ranks):
    for r in ranks["ranks"]:
        assert int(r["dcp/latest_after_half"]) == 2
        assert int(r["dcp/step"]) == 4 and r["dcp/steps"].tolist() == [2, 4]
    _only_rank_1_running_stats(ranks, "dcp/differ")
    names = sorted(os.listdir(os.path.join(ranks["tmp"], "dcp", "dcp")))
    assert names == ["step_00000002", "step_00000004"]


def test_distributed_eval_equals_one_process(ranks, tmp_path):
    r0, r1 = ranks["ranks"]
    assert bool(r1["eval/is_none"]) and not bool(r0["eval/is_none"])
    cfg = ranks["cfgs"]["eval"]
    one = eval_entry.run_eval(cfg, device="cpu", result_dir=str(tmp_path / "one"))
    np.testing.assert_array_equal(r0["eval/stats"], one)
    val = CocoJson(cfg.val_path)
    want = sorted(f"{im['id']}.json" for im in val.dataset["images"] if val.img_anns.get(im["id"]))
    assert r0["eval/shards"].tolist() == want
    merged = json.load(open(os.path.join(ranks["tmp"], "eval_dist", "bbox_detections.json")))
    assert merged == json.load(open(tmp_path / "one" / "bbox_detections.json"))


def test_rank_0_gated_eval_covers_every_image(ranks):
    r0 = ranks["ranks"][0]
    assert int(r0["gated/shards"]) == int(r0["gated/images"]) > 0
    assert r0["gated/stats"].shape == (12,) and np.isfinite(r0["gated/stats"]).all()


def test_entry_under_torchrun_without_a_card_raises(monkeypatch):
    """``WORLD_SIZE`` set (a ``torchrun`` launch) and no ``--use_gpu
    false``: the entry asks for NCCL on a card and raises without one; it
    never falls back to gloo on the CPU."""
    import torch

    from ppyolo_tpu_torch.entry import train as train_entry
    from ppyolo_tpu_torch.parallel import dist

    if torch.cuda.is_available():
        pytest.skip("a card is present: NCCL would start")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_entry.main(["--config", "1"])
    assert not dist.active()
