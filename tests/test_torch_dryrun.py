"""The port's dry-run (``repro_torch.launch.dryrun`` / ``dryrun_all``):
the reference's minicell, run on the CPU under the ``fake`` process group
at the production (16, 16) mesh, asserts what the reference's minicell
asserts (tests/test_parallel.py) and its ``analytic_terms`` fields equal
the JAX package's for the same ``Cell``; the collective bytes of one
closed-form case on a fake (4, 1) mesh (an FSDP-sharded leaf's all-gather
and its gradient's reduce-scatter) equal the bytes worked out by hand;
the memory tracker counts new storage only; the sweep caches, skips and
runs cells.  Each cell runs in a subprocess (one fake group a process)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.launch import analytic as JA
from repro.models import model as JM
from repro_torch.configs import base as cb
from repro_torch.launch import dryrun, dryrun_all
from repro_torch.launch import mesh as mesh_lib

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
# the count fields of analytic_terms (the seconds divide them by each
# package's own device constants)
EXACT = ("an_flops_per_device", "an_bytes_per_device",
         "an_collective_bytes_per_device", "an_useful_ratio")


def _python(code, timeout=600):
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=ENV,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def minicell(tmp_path_factory):
    out = tmp_path_factory.mktemp("cell") / "cell.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internvl2-1b", "--shape", "decode_32k", "--device", "cpu",
         "--out", str(out)], capture_output=True, text=True, env=ENV,
        timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def test_minicell_asserts_what_the_reference_asserts(minicell):
    res = minicell
    assert res["chips"] == 256
    assert res["an_step_s"] > 0
    assert res["bottleneck"] in ("compute", "memory", "collective")
    assert res["an_bottleneck"] in ("compute", "memory", "collective")
    for k in ("flops_per_device", "bytes_per_device",
              "argument_bytes_per_device", "temp_bytes_per_device",
              "hbm_required_bytes"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    assert set(res["collective_detail"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute", "total"}
    assert res["fits_hbm"] == (res["hbm_required_bytes"] <= 80e9)
    assert res["host_seconds"] > 0


def test_minicell_analytic_terms_equal_reference(minicell):
    cfg = jcb.get_config("internvl2-1b")
    want = JA.analytic_terms(JA.Cell(
        cfg=cfg, shape=jcb.SHAPES["decode_32k"], chips=256, tp=16, fsdp=16,
        grad_accum=1, opt_state_bytes_per_param=8.0))
    for k in want:
        assert k in minicell, k
    for k in EXACT:
        assert minicell[k] == want[k], k
    assert minicell["an_compute_s"] == \
        minicell["an_flops_per_device"] / mesh_lib.PEAK_BF16_FLOPS
    assert minicell["an_memory_s"] == \
        minicell["an_bytes_per_device"] / mesh_lib.HBM_BW
    assert minicell["model_flops"] == JM.model_flops(
        cfg, jcb.SHAPES["decode_32k"])


def test_collective_bytes_closed_form():
    """On a fake (4, 1) ("data", "model") mesh: a (64, 32) float32 weight
    FSDP-sharded over 'data' (16 rows a rank), gathered for a matmul with
    this rank's 8 rows of a batch split over 'data', the loss summed over
    the ranks.  By hand, per device: one all-gather of the whole weight
    (64 * 32 * 4 = 8192 bytes), one reduce-scatter of its gradient onto
    the shard (16 * 32 * 4 = 2048 bytes), one all-reduce of the float32
    loss (4 bytes)."""
    out = _python("""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.launch import dryrun, mesh as mesh_lib
        from repro_torch.parallel import ctx, sharding as shd
        from repro_torch.train.loop import value_and_grad
        dryrun._fake_group(4)
        mesh = mesh_lib.make_local_mesh(4, 1, "cpu")
        counter = dryrun.StepCounter()
        with FakeTensorMode():
            w = dryrun._dtensor((64, 32), torch.float32,
                                shd.NamedSharding(mesh, shd.P("data", None)),
                                "cpu")
            x = torch.empty(8, 64)
            with ctx.mesh_context(mesh), ctx.rows_split_over(("data",)), \\
                    counter:
                (_, _), g = value_and_grad(
                    lambda p: (ctx.batch_sum((x @ ctx.gather(p["w"])).sum()),
                               {}), dict(w=w))
            pl = [str(p) for p in g["w"].placements]
        print(json.dumps(dict(coll=counter.coll, counts=counter.counts,
                              placements=pl)))
    """)
    res = json.loads(out.strip().splitlines()[-1])
    assert res["coll"] == {"all-reduce": 4, "all-gather": 8192,
                           "reduce-scatter": 2048, "all-to-all": 0,
                           "collective-permute": 0}
    assert res["counts"] == {"all-reduce": 1, "all-gather": 1,
                             "reduce-scatter": 1, "all-to-all": 0,
                             "collective-permute": 0}


def test_tensor_parallel_mlp_closed_form():
    """On a fake (1, 4) ("data", "model") mesh: gemma-2b's smoke MLP
    (GeGLU, d 64, d_ff 128) on its stored placements (the last dim on
    'model'), forward over 8 rows.  By hand, per device: a quarter of the
    whole block's flops (2 * 8 * 64 * 128 for each of gate and up, the
    same for down: 393,216 in all, 98,304 a rank) and one all-reduce of
    the (8, 64) float32 output after the row-parallel ``w_down``
    (2,048 bytes); the MLP noted as split 4 ways."""
    out = _python("""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.configs import base as cb
        from repro_torch.launch import dryrun, mesh as mesh_lib
        from repro_torch.models import layers as L
        from repro_torch.parallel import ctx, sharding as shd
        dryrun._fake_group(4)
        mesh = mesh_lib.make_local_mesh(1, 4, "cpu")
        cfg = cb.get_smoke_config("gemma-2b")
        shapes = L.mlp_init(L.Draw(None, "meta"), cfg, 64, 128,
                            torch.float32)
        counter = dryrun.StepCounter()
        with FakeTensorMode():
            p = {k: dryrun._dtensor(tuple(v.shape), torch.float32,
                                    shd.NamedSharding(mesh, shd.param_spec(
                                        "blocks/mlp/" + k, tuple(v.shape),
                                        mesh, min_size_fsdp=2 ** 10)),
                                    "cpu") for k, v in shapes.items()}
            x = torch.empty(1, 8, 64)
            fl = FlopCounterMode(display=False)
            ctx.split_kinds(reset=True)
            with ctx.mesh_context(mesh), counter, fl:
                y = L.mlp_apply(p, x, cfg)
        print(json.dumps(dict(flops=fl.get_total_flops(),
                              reduce=counter.coll["all-reduce"],
                              n_reduce=counter.counts["all-reduce"],
                              shape=list(y.shape),
                              kinds=ctx.split_kinds())))
    """)
    res = json.loads(out.strip().splitlines()[-1])
    assert res["flops"] == 3 * 2 * 8 * 64 * 128 // 4
    assert (res["reduce"], res["n_reduce"]) == (8 * 64 * 4, 1)
    assert res["shape"] == [1, 8, 64]
    assert res["kinds"] == {"split": {"mlp": 4}, "repeat": []}


def test_shard_to_shard_counts_as_all_to_all():
    """DTensor's shard-to-shard move on a GPU mesh (``_dtensor::
    shard_dim_alltoall``, the stored column shard of a weight to the row
    shard a row-parallel matmul reads) counts as one all-to-all of its
    result bytes: (16, 8) float32 on 4 ranks to (4, 32), 512 bytes."""
    out = _python("""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.launch import dryrun, mesh as mesh_lib
        dryrun._fake_group(4)
        mesh = mesh_lib.make_local_mesh(1, 4, "cpu")
        counter = dryrun.StepCounter()
        with FakeTensorMode():
            x = torch.empty(16, 8)
            with counter:
                y = torch.ops._dtensor.shard_dim_alltoall(
                    x, 1, 0, mesh.get_group(1).group_name)
        print(json.dumps(dict(shape=list(y.shape), coll=counter.coll,
                              counts=counter.counts)))
    """)
    res = json.loads(out.strip().splitlines()[-1])
    assert res["shape"] == [4, 32]
    assert res["coll"]["all-to-all"] == 4 * 32 * 4
    assert res["counts"] == {"all-reduce": 0, "all-gather": 0,
                             "reduce-scatter": 0, "all-to-all": 1,
                             "collective-permute": 0}


def test_memory_tracker_counts_new_storage_only():
    from torch._subclasses.fake_tensor import FakeTensorMode
    counter = dryrun.StepCounter()
    with FakeTensorMode():
        a = torch.empty(1000)                 # 4000 bytes
        counter.hold(a)
        with counter:
            v = a[10:]                        # a view: no new storage
            a.add_(1.0)                       # in place: none
            assert counter.live == 4000
            b = a * 2.0
            assert counter.live == 8000
            del b
            assert counter.live == 4000
            c = torch.cat([a, v])             # 1990 floats
        assert counter.peak == 4000 + 7960
        del c
    assert counter.live == 4000


def test_unsupported_shape_and_device():
    with pytest.raises(SystemExit, match="SKIP"):
        dryrun.build_cell("gemma-2b", "long_500k", False,
                          mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k"])


def test_sweep_caches_skips_and_runs(tmp_path, capsys, monkeypatch):
    """internvl2-1b, single pod: train_4k and prefill_32k cached,
    decode_32k run in its own process, long_500k recorded as skipped (a
    full-attention arch)."""
    monkeypatch.setenv("PYTHONPATH", SRC)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = tmp_path / "res"
    res.mkdir()
    for s in ("train_4k", "prefill_32k"):
        (res / f"internvl2-1b__{s}__single.json").write_text("{}")
    st = dryrun_all.main(["--results", str(res), "--only", "single",
                          "--arch", "internvl2-1b", "--device", "cpu",
                          "--timeout", "600"])
    assert st == {"internvl2-1b__train_4k__single": "cached",
                  "internvl2-1b__prefill_32k__single": "cached",
                  "internvl2-1b__decode_32k__single": "ok",
                  "internvl2-1b__long_500k__single": "skip"}
    skip = json.loads((res / "internvl2-1b__long_500k__single.json")
                      .read_text())
    assert skip["skipped"] and "full attention" in skip["reason"]
    cell = json.loads((res / "internvl2-1b__decode_32k__single.json")
                      .read_text())
    assert cell["chips"] == 256
    out = capsys.readouterr().out
    assert "[3/4] internvl2-1b__decode_32k__single: ok" in out


def test_sweep_order_and_shapes_equal_reference():
    from repro.launch import dryrun_all as jall
    assert dryrun_all.ORDER == jall.ORDER
    assert dryrun_all.SHAPES == jall.SHAPES
    assert list(dryrun_all.cells(["a"], None)) == \
        list(jall.cells(["a"], None))
    assert sorted(dryrun_all.ORDER) == sorted(cb.ARCH_IDS)


# the smoke configs' widths as overrides of the published configs (the
# dry-run's CLI takes a published config and ``--override``)
SMOKE_WIDTHS = {
    "mixtral-8x22b": dict(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=512, num_experts=4, top_k=2,
                          moe_d_ff=128),
    "falcon-mamba-7b": dict(num_layers=2, d_model=64, d_inner=128,
                            dt_rank=8, ssm_state=4, vocab_size=512),
}


@pytest.mark.parametrize("arch,kind", [("mixtral-8x22b", "moe"),
                                       ("falcon-mamba-7b", "mamba1")])
def test_fake_4x2_train_cell_splits_the_kind(tmp_path, arch, kind):
    """On a fake (4, 2) ("data", "model") mesh, a width-cut train_4k
    cell (8 x 64 tokens) splits its MoE experts / Mamba1 channels over
    'model' (two ways) and repeats no kind."""
    out = tmp_path / "cell.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "train_4k", "--mesh-data", "4", "--mesh-model", "2",
         "--batch", "8", "--seq", "64", "--device", "cpu", "--override",
         json.dumps(SMOKE_WIDTHS[arch]), "--out", str(out)],
        capture_output=True, text=True, env=ENV, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(out.read_text())
    assert res["chips"] == 8
    assert res["model_split"]["split"][kind] == 2, res["model_split"]
    assert res["model_split"]["repeat"] == [], res["model_split"]


def test_decode_cell_reads_the_ssm_states_model_shard():
    """A falcon-mamba-7b decode cell (width-cut, 8 x 64) on a fake (4, 2)
    mesh: the SSM and conv states reach the layers as this rank's 'model'
    shard (half the channels; the other entries' split dims gathered),
    the arguments count that shard, and Mamba1 and the logits split."""
    over = json.dumps(json.dumps(SMOKE_WIDTHS["falcon-mamba-7b"]))
    out = _python(f"""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.launch import dryrun, mesh as mesh_lib
        from repro_torch.parallel import ctx
        dryrun._fake_group(8)
        mesh = mesh_lib.make_local_mesh(4, 2, "cpu")
        with FakeTensorMode():
            mesh, cfg, shape, run, args, meta = dryrun.build_cell(
                "falcon-mamba-7b", "decode_32k", False, json.loads({over}),
                "cpu", mesh, batch=8, seq=64)
            batch = args[1]
            with ctx.mesh_context(mesh):
                rows, axes = dryrun.local_inputs(batch, mesh, cfg)
                ctx.split_kinds(reset=True)
                run()
                kinds = ctx.split_kinds(reset=True)
            got = {{k: list(v.shape) for k, v in rows["cache"].items()}}
            stored = {{k: list(v.to_local().shape)
                      for k, v in batch["cache"].items()}}
        print(json.dumps(dict(rows=got, stored=stored, axes=list(axes),
                              cache_bytes=meta["cache_bytes"],
                              kinds=kinds, tokens=list(rows["tokens"].shape))))
    """)
    res = json.loads(out.strip().splitlines()[-1])
    L, B, di, N, K = 2, 8 // 4, 128, 4, 4
    assert res["rows"] == {"ssm_state": [L, B, di // 2, N],
                           "conv_state": [L, B, K - 1, di // 2]}
    assert res["rows"] == res["stored"]
    assert res["cache_bytes"] == 4 * L * B * (di // 2) * N + \
        2 * L * B * (K - 1) * (di // 2)
    assert res["axes"] == ["data"] and res["tokens"] == [B, 1]
    assert res["kinds"] == {"split": {"logits": 2, "mamba1": 2},
                            "repeat": []}
