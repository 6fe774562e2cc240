"""The bodies of the port's spawned gloo worlds (``_torch_dist``): each
runs on every rank and returns rank 0's ``checks`` dict.  No ``jax`` and
no ``repro`` here: the tests hold the returned values against the JAX
package in their own process."""
import numpy as np
import torch

from _torch_dist import checks


def _pl(p):
    """A placement as plain data: ``("Shard", dim)``, ``("Replicate",)``,
    ``("Partial",)``."""
    return ("Shard", p.dim) if p.is_shard() else (type(p).__name__,)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------


def parallel_world(rank, world, inp):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.compile import compile_model
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import resnet as R
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import ctx, pp
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.loop import value_and_grad

    from torch.distributed.device_mesh import init_device_mesh

    m22 = mesh_lib.make_local_mesh(2, 2, "cpu")
    model4 = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    stage4 = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
    dp4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))

    def gather_all(x):
        out = [None] * world
        dist.all_gather_object(out, x)
        return out

    def stacked():
        full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
        sh = shd.NamedSharding(m22, shd.P(("data", "model"), None))
        d = shd.distribute(full, sh)
        # data-major: rank (d, m) holds row block 2 d + m
        blocks = gather_all(d.to_local().numpy())
        return dict(placements=tuple(_pl(p) for p in d.placements),
                    whole=bool(torch.equal(d.full_tensor(), full)),
                    blocks=[b.tolist() for b in blocks])

    def refuses():
        try:
            mesh_lib.make_local_mesh(2, 1, "cpu")
        except ValueError as e:
            return str(e)
        return None

    def constrain():
        x = DTensor.from_local(torch.arange(48.).reshape(8, 6), m22,
                               [Replicate(), Replicate()])
        y = torch.arange(18.).reshape(3, 6)
        with ctx.mesh_context(m22):
            a = ctx.constrain(x, "data", "model")
            b = ctx.constrain(DTensor.from_local(y, m22, [Replicate()] * 2),
                              "data", None)
            c = ctx.constrain(y, "data", None)
        no_mesh = ctx.constrain(x, "data", "model")
        return dict(a=tuple(_pl(p) for p in a.placements),
                    a_whole=bool(torch.equal(a.full_tensor(), x.full_tensor())),
                    b=tuple(_pl(p) for p in b.placements),
                    plain_is_identity=c is y, no_mesh_is_identity=no_mesh is x)

    def sharded_take():
        emb = torch.from_numpy(inp["emb"])
        tok = torch.from_numpy(inp["tok"])
        table = shd.distribute(emb, shd.NamedSharding(m22, shd.P(None, "model")))
        seen = {}

        def loss(p):
            h = ctx.sharded_take(p["t"], rows["tokens"])
            seen["h"] = h.detach()
            return ctx.batch_sum((h * torch.arange(1., 9.)).sum()), {}

        with ctx.mesh_context(m22):
            rows, axes = ctx.local_rows(dict(tokens=tok))
            with ctx.rows_split_over(axes):
                (s, _), g = value_and_grad(loss, dict(t=table))
        got = torch.cat(gather_all(seen["h"]))
        return dict(axes=axes, rows=got.numpy(),
                    loss=float(s), grad=g["t"].full_tensor().numpy(),
                    grad_placements=tuple(_pl(p) for p in g["t"].placements))

    def cmatmul():
        x = shd.distribute(torch.from_numpy(inp["cm_x"]),
                           shd.NamedSharding(model4, shd.P("model", None)))
        w = shd.distribute(torch.from_numpy(inp["cm_w"]),
                           shd.NamedSharding(model4, shd.P(None, "model")))
        y = C.collective_matmul(x, w, model4, "model")
        return dict(y=y.full_tensor().numpy(),
                    placements=tuple(_pl(p) for p in y.placements))

    def pipeline():
        ws = [0.5, 1.5, -2.0, 3.0]
        f = pp.pipeline_step(lambda i, x: x * ws[i] + 1.0, stage4, "stage",
                             n_micro=6)
        return f(torch.arange(18, dtype=torch.float32).reshape(6, 3)).numpy()

    def compressed(key):
        def run():
            g = torch.from_numpy(inp[key + "_g"][rank])
            e = torch.from_numpy(inp[key + "_e"][rank])
            out, new_e = C.compressed_psum_grads(
                dict(w=g), dict(w=e), "data", block=inp[key + "_block"],
                mesh=dp4)
            return dict(out=gather_all(out["w"].numpy()),
                        err=gather_all(new_e["w"].numpy()),
                        zero=C.init_error_state(dict(w=g))["w"].abs().sum()
                        .item())
        return run

    qp = inp["qp8"]
    imgs = torch.from_numpy(inp["imgs"])

    def sharded_serve():
        cm = compile_model(R.RESNET8, qp, backend="torch-int",
                           batch_sizes=(8,), device="cpu")
        ref = cm(imgs).numpy()
        out = cm.run_sharded(imgs, dp4)
        out5 = cm.run_sharded(imgs[:5], dp4)
        first = dict(execs=len(cm._shard_execs),
                     lowered=len(cm._shard_lowered),
                     compile_count=cm.compile_count)
        # the same ranks, another mesh shape: a new executable on the same
        # lowering; the 2x2 mesh splits the batch over 'data' (2 ways)
        out22 = cm.run_sharded(imgs, m22, "data")
        return dict(ref=ref, full=out.full_tensor().numpy(),
                    placements=tuple(_pl(p) for p in out.placements),
                    local_rows=out.to_local().shape[0],
                    five=out5.full_tensor().numpy(),
                    five_shape=tuple(out5.shape), first=first,
                    m22=out22.full_tensor().numpy(),
                    after=dict(execs=len(cm._shard_execs),
                               lowered=len(cm._shard_lowered),
                               compile_count=cm.compile_count),
                    keys=sorted((k[0], k[1], k[2])
                                for k in cm._shard_execs))

    def sharded_traced():
        # a sharded bucket run with a session on: one host span ``call``,
        # the local eager executable no phase, the logits unchanged
        from repro_torch import obs
        cm = compile_model(R.RESNET8, qp, backend="torch-int",
                           batch_sizes=(8,), device="cpu")
        ob = obs.instrument()
        try:
            out = cm.run_sharded(imgs[:5], dp4)
            ob.flush()
        finally:
            obs.disable()
        return dict(five=out.full_tensor().numpy(),
                    spans=[(e.name, e.args) for e in ob.trace.events
                           if e.track == "calls"])

    def serve_errors():
        msgs = []
        cm = compile_model(R.RESNET8, qp, backend="torch-int",
                           batch_sizes=(6, 8), device="cpu")
        for call in (lambda: cm.shard_executable(dp4, 3),
                     lambda: cm.shard_executable(dp4, 6)):
            try:
                call()
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        cm6 = compile_model(R.RESNET8, qp, backend="torch-int",
                            batch_sizes=(6,), device="cpu")
        try:
            cm6.run_sharded(imgs, dp4)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
        return msgs

    return checks([
        ("stacked_placements", stacked), ("local_mesh_refuses", refuses),
        ("constrain", constrain), ("sharded_take", sharded_take),
        ("collective_matmul", cmatmul), ("pipeline_step", pipeline),
        ("compressed_even", compressed("even")),
        ("compressed_ragged", compressed("ragged")),
        ("run_sharded", sharded_serve), ("run_sharded_errors", serve_errors),
        ("run_sharded_traced", sharded_traced),
    ])


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_train.py
# ---------------------------------------------------------------------------


def _lm_batch(cfg, seed, batch, seq):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out = dict(tokens=tok, labels=np.concatenate(
        [tok[:, 1:], -np.ones((batch, 1), np.int32)], axis=1))
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _clone(tree):
    from repro_torch.core import tree as T
    return T.tree_map(lambda t: t.clone(), tree)


def train_world(rank, world, inp):
    """Gradients of the ten smoke configs and two train steps of three,
    sharded on a (2, 2) mesh against the port's unsharded ones computed on
    each rank; a checkpoint written on (2, 2) and restored onto (4, 1)."""
    from repro_torch.configs import base as cb
    from repro_torch.core import quant as Q
    from repro_torch.core import tree as T
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import value_and_grad

    m22 = mesh_lib.make_local_mesh(2, 2, "cpu")
    # FSDP from 2**10 elements: at smoke size the default 2**18 shards no
    # leaf over 'data'
    kw = dict(min_size_fsdp=2 ** 10)

    def worst_rel(want, got):
        """Largest error of a leaf over that leaf's largest magnitude."""
        worst = 0.0
        for (k, a), b in zip(T.flatten_with_path(want), T.leaves(got)):
            if a is None:
                assert b is None, k
                continue
            b = b.full_tensor() if hasattr(b, "full_tensor") else b
            a, b = a.to(torch.float32), b.to(torch.float32)
            scale = float(a.abs().max())
            if scale:
                worst = max(worst, float((a - b).abs().max()) / scale)
        return worst

    def grads(arch, **over):
        def run():
            cfg = cb.get_smoke_config(arch).with_(**over)
            p = M.init_params(cfg, 0, "cpu")
            batch = _lm_batch(cfg, 1, 4, 16)
            (l0, _), g0 = value_and_grad(
                lambda q: M.loss_fn(q, cfg, batch), p)
            sh = shd.params_shardings(p, m22, **kw)
            pd = shd.distribute_tree(p, sh)
            with ctx.mesh_context(m22):
                rows, axes = ctx.local_rows(batch)
                with ctx.rows_split_over(axes):
                    (l1, _), g1 = value_and_grad(
                        lambda q: M.loss_fn(q, cfg, rows), pd)
            n_sharded = sum(any(pl.is_shard() for pl in x.placements)
                            for x in T.leaves(pd))
            n_layer = sum(any(pl.is_shard(0) for pl in x.placements)
                          for x in T.leaves(pd) if x.dim() == 2
                          and x.shape[0] == cfg.num_layers)
            same_pl = all(tuple(a.placements) == tuple(b.placements)
                          for a, b in zip(T.leaves(pd), T.leaves(g1))
                          if b is not None)
            return dict(loss=(float(l0), float(l1)), rel=worst_rel(g0, g1),
                        axes=axes, n_sharded=n_sharded, same_pl=same_pl,
                        n_layer_sharded=n_layer)
        return run

    saved = {}

    def steps(arch, int8):
        def run():
            cfg = cb.get_smoke_config(arch)
            p = inp["params"][arch]
            hp = dict(inp["hp"], int8_state=int8)
            opt = opt_lib.adamw(**hp)
            step = S.make_train_step(cfg, opt, grad_accum=2)
            pu = _clone(p)
            su = opt.init(pu)
            sh = shd.params_shardings(p, m22, **kw)
            ps = shd.distribute_tree(p, sh)
            ss = opt.init(ps)
            losses, ulosses = [], []
            for i in range(2):
                batch = _lm_batch(cfg, 10 + i, 8, 16)
                pu, su, mu = step(pu, su, i, batch)
                with ctx.mesh_context(m22):
                    ps, ss, ms = step(ps, ss, i, batch)
                ulosses.append(float(mu["loss"]))
                losses.append(float(ms["loss"]))

            def host(x):
                x = x.full_tensor() if hasattr(x, "full_tensor") else x
                return x.numpy()

            def moments(state):
                """Each moment leaf as ("f", array) or ("q", q, exp)."""
                out = []
                for k in ("m", "v"):
                    for path, _ in T.flatten_with_path(pu):
                        x = state[k]
                        for key in path.split("/"):
                            x = x[key]
                        out.append(("q", host(x.q), host(x.exp))
                                   if isinstance(x, Q.BlockQuantized)
                                   else ("f", host(x)))
                return out

            out = dict(losses=losses, ulosses=ulosses,
                       uparams=[host(t) for t in T.leaves(pu)],
                       params=[host(t) for t in T.leaves(ps)],
                       umoments=moments(su), moments=moments(ss))
            if arch == "gemma-2b" and int8:
                saved.update(ps=ps, ss=ss, sh=sh, opt=opt, cfg=cfg)
            return out
        return run

    def checkpoint():
        d = inp["ckpt_dir"]
        ps, ss = saved["ps"], saved["ss"]
        ck.save(d, 7, (ps, ss), extra=dict(mesh="2x2"))
        ck.save_async(d, 8, (ps, ss))
        ck.wait_pending()
        torch.distributed.barrier()     # rank 0's thread has written
        written = sorted(ck.latest_steps(d))
        m41 = mesh_lib.make_local_mesh(4, 1, "cpu")
        fresh = M.init_params(saved["cfg"], 3, "cpu")
        p41 = shd.params_shardings(fresh, m41, **kw)
        fresh = shd.distribute_tree(fresh, p41)
        st = saved["opt"].init(fresh)
        (rp, rs), step, extra = ck.restore(
            d, (fresh, st), step=7,
            shardings=(p41, shd.state_shardings(st, p41)))
        same = all(torch.equal(a.full_tensor(), b.full_tensor())
                   for a, b in zip(T.leaves((rp, rs)), T.leaves((ps, ss))))
        placed = all(tuple(a.placements) == tuple(s.placements)
                     for a, s in zip(T.leaves(rp), T.leaves(p41)))
        n41 = sum(any(pl.is_shard() for pl in a.placements)
                  for a in T.leaves(rp))
        # restored onto the target's own placements when no shardings
        (rp2, _), _, _ = ck.restore(d, (ps, ss), step=8)
        same2 = all(torch.equal(a.full_tensor(), b.full_tensor()) and
                    tuple(a.placements) == tuple(b.placements)
                    for a, b in zip(T.leaves(rp2), T.leaves(ps)))
        return dict(written=written, step=step, extra=extra, same=same,
                    placed=placed, n41=n41, same2=same2,
                    full=T.tree_map(lambda t: t.full_tensor().numpy(),
                                    (ps, ss)))

    def refuses_int8():
        cfg = cb.get_smoke_config("zamba2-7b")
        p = shd.distribute_tree(M.init_params(cfg, 0, "cpu"),
                                shd.params_shardings(
                                    M.init_params(cfg, 0, "meta"), m22, **kw))
        try:
            opt_lib.adamw(int8_state=True, state_block=32).init(p)
        except ValueError as e:
            return str(e)
        return None

    pairs = [(f"grads/{a}", grads(a)) for a in cb.ARCH_IDS]
    # QAT's dynamic exponent is a statistic of the whole batch
    pairs += [("grads/qat", grads("llama3.2-3b", quant="qat"))]
    # (L, d_inner) leaves of 2 x 8,192 take FSDP on their layer dim
    pairs += [("grads/layer-sharded",
               grads("falcon-mamba-7b", d_inner=8192))]
    pairs += [(f"steps/{a}/{'int8' if q else 'float'}", steps(a, q))
              for a in inp["params"] for q in (False, True)]
    pairs += [("checkpoint", checkpoint), ("refuses_int8", refuses_int8)]
    return checks(pairs)


# ---------------------------------------------------------------------------
# tests/test_torch_tp.py
# ---------------------------------------------------------------------------


def tp_world(rank, world, inp):
    """Tensor parallelism over 'model' on a (data, model) mesh of
    ``inp["mesh"]``: train steps and QAT gradients against the unsharded
    ones, the add-fold counted once, the vocabulary-parallel cross entropy
    against the whole-vocabulary one, and one MLP block's flops a rank."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import base as cb
    from repro_torch.core import tree as T
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as S
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import value_and_grad

    D, Mo = inp["mesh"]
    mesh = mesh_lib.make_local_mesh(D, Mo, "cpu")
    kw = dict(min_size_fsdp=2 ** 10)

    def host(x):
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        return None if x is None else x.detach().numpy()

    def steps(arch, int8):
        def run():
            cfg = cb.get_smoke_config(arch)
            p = inp["params"][arch]
            opt = opt_lib.adamw(**dict(inp["hp"], int8_state=int8))
            step = S.make_train_step(cfg, opt, grad_accum=2)
            pu = T.tree_map(lambda t: t.clone(), p)
            su = opt.init(pu)
            ps = shd.distribute_tree(p, shd.params_shardings(p, mesh, **kw))
            ss = opt.init(ps)
            losses, ulosses = [], []
            ctx.split_kinds(reset=True)
            for i in range(2):
                batch = _lm_batch(cfg, 10 + i, 8, 16)
                pu, su, mu = step(pu, su, i, batch)
                with ctx.mesh_context(mesh):
                    ps, ss, ms = step(ps, ss, i, batch)
                ulosses.append(float(mu["loss"]))
                losses.append(float(ms["loss"]))
            return dict(losses=losses, ulosses=ulosses,
                        uparams=[host(t) for t in T.leaves(pu)],
                        params=[host(t) for t in T.leaves(ps)],
                        kinds=ctx.split_kinds(reset=True))
        return run

    def grads(arch, **over):
        def run():
            cfg = cb.get_smoke_config(arch).with_(**over)
            p = M.init_params(cfg, 0, "cpu")
            batch = _lm_batch(cfg, 1, 4, 16)
            (l0, _), g0 = value_and_grad(
                lambda q: M.loss_fn(q, cfg, batch), p)
            pd = shd.distribute_tree(p, shd.params_shardings(p, mesh, **kw))
            ctx.split_kinds(reset=True)
            with ctx.mesh_context(mesh):
                rows, axes = ctx.local_rows(batch)
                with ctx.rows_split_over(axes):
                    (l1, _), g1 = value_and_grad(
                        lambda q: M.loss_fn(q, cfg, rows), pd)
            return dict(loss=(float(l0), float(l1)),
                        grads=[host(t) for t in T.leaves(g0)],
                        sharded=[host(t) for t in T.leaves(g1)],
                        kinds=ctx.split_kinds(reset=True))
        return run

    def layer_weights(arch, zero):
        """A smoke config's first block: its weights whole and on the
        mesh, ``zero`` (wo / w_down) set to 0."""
        cfg = cb.get_smoke_config(arch)
        blk = T.tree_map(lambda t: t[0], M.init_params(cfg, 0, "cpu")["blocks"])
        for sub, name in zero:
            blk[sub][name] = torch.zeros_like(blk[sub][name])
        on = shd.distribute_tree(blk, shd.params_shardings(blk, mesh))
        return cfg, blk, on

    def add_fold():
        """``acc_init`` enters once: with the block's output weight zero its
        output is the skip stream itself, and otherwise the unsharded
        block's (MLP and GQA attention, gemma-2b's smoke config)."""
        out = {}
        gen = torch.Generator().manual_seed(3)
        for zero in (True, False):
            cfg, blk, on = layer_weights(
                "gemma-2b", [("mlp", "w_down"), ("attn", "wo")] if zero
                else [])
            x = torch.randn((2, 8, cfg.d_model), generator=gen)
            skip = torch.randn((2, 8, cfg.d_model), generator=gen)
            want_m = L.mlp_apply(blk["mlp"], x, cfg, acc_init=skip)
            want_a, _ = L.gqa_apply(blk["attn"], x, cfg, acc_init=skip)
            ctx.split_kinds(reset=True)
            with ctx.mesh_context(mesh):
                got_m = L.mlp_apply(on["mlp"], x, cfg, acc_init=skip)
                got_a, _ = L.gqa_apply(on["attn"], x, cfg, acc_init=skip)
            out["zero" if zero else "whole"] = dict(
                skip=skip.numpy(), mlp=(host(want_m), host(got_m)),
                attn=(host(want_a), host(got_a)),
                kinds=ctx.split_kinds(reset=True))
        return out

    def vocab_xent():
        """``chunked_xent`` over the vocabulary split on 'model' (tied
        (V, d) table and untied (d, V) leaf, with a softcap, ignored
        labels) against the whole table: value and gradients."""
        gen = torch.Generator().manual_seed(5)
        V, d, B, Sq = 512, 32, 4, 8
        h0 = torch.randn((B, Sq, d), generator=gen)
        labels = torch.randint(0, V, (B, Sq), generator=gen)
        labels[0, :3] = -100
        tab = torch.randn((V, d), generator=gen)
        out = {}
        for name, leaf, vdim, cap in (("tied", tab, 0, 0.0),
                                      ("untied", tab.T.contiguous(), 1, 30.0)):
            def loss(p, hh, lab):
                emb, v0 = L.vocab_part(p["w"], vdim)
                s, c = L.chunked_xent(hh, emb, lab, 4, cap, v0=v0)
                return s, dict(c=c)
            h = h0.clone().requires_grad_(True)
            (s0, m0), g0 = value_and_grad(
                lambda p: loss(p, h, labels), dict(w=leaf))
            (gh0,) = torch.autograd.grad(loss(dict(w=leaf), h, labels)[0], h)
            on = shd.distribute_tree(dict(w=leaf), shd.params_shardings(
                dict(w=leaf), mesh, min_size_fsdp=2 ** 10))
            with ctx.mesh_context(mesh):
                rows, axes = ctx.local_rows(dict(h=h0, labels=labels))
                with ctx.rows_split_over(axes):
                    hr = rows["h"].clone().requires_grad_(True)
                    (s1, m1), g1 = value_and_grad(
                        lambda p: loss(p, hr, rows["labels"]), on)
                    (gh1,) = torch.autograd.grad(
                        loss(on, hr, rows["labels"])[0], hr)
                    v0 = L.vocab_part(on["w"], vdim)[1]
            nr = rows["h"].shape[0]
            lo = ctx._rows_index(mesh, axes)[0] * nr if axes else 0
            out[name] = dict(
                loss=(float(s0), float(s1)), count=(int(m0["c"]),
                                                    int(m1["c"])),
                grad=(host(g0["w"]), host(g1["w"])),
                grad_h=(gh0.numpy()[lo:lo + nr], gh1.numpy()), v0=v0)
        return out

    def mlp_flops():
        """Each rank's flops of one MLP block (forward and backward) at
        the mesh's 'model' extent against the whole block's."""
        cfg, blk, on = layer_weights("granite-8b", [])
        x = torch.randn((2, 16, cfg.d_model))
        for t in T.leaves(blk["mlp"]) + T.leaves(on["mlp"]):
            t.requires_grad_(True)

        def count(p, mesh_):
            fl = FlopCounterMode(display=False)
            with ctx.mesh_context(mesh_), fl:
                xx = x.clone().requires_grad_(True)
                y = L.mlp_apply(p, xx, cfg)
                y.sum().backward()
            return fl.get_total_flops()
        return dict(whole=count(blk["mlp"], None),
                    rank=count(on["mlp"], mesh), tp=Mo)

    if "partial" in inp:
        # heads that share a factor with 'model' but do not divide it
        return checks([(f"partial/{a}", grads(a, **over))
                       for a, over in inp["partial"].items()])
    pairs = [(f"steps/{a}/{'int8' if q else 'float'}", steps(a, q))
             for a in inp["params"] for q in (False, True)]
    pairs += [(f"qat/{a}", grads(a, quant="qat")) for a in inp["qat"]]
    pairs += [("add_fold", add_fold), ("vocab_xent", vocab_xent),
              ("mlp_flops", mlp_flops)]
    return checks(pairs)


# ---------------------------------------------------------------------------
# tests/test_torch_tp_kinds.py
# ---------------------------------------------------------------------------


def kind_steps(cfg, p, hp, mesh=None):
    """Two ``make_train_step`` steps (``grad_accum=2``) of ``cfg`` from
    the parameters ``p`` (left as they are): on ``mesh`` (the parameters
    distributed, the layer kinds noted from a reset) or, without one, on
    this process.  Returns (params, losses)."""
    from repro_torch.core import tree as T
    from repro_torch.launch import steps as S
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import optimizer as opt_lib

    opt = opt_lib.adamw(**hp)
    step = S.make_train_step(cfg, opt, grad_accum=2)
    p = T.tree_map(lambda t: t.clone(), p)
    if mesh is not None:
        p = shd.distribute_tree(p, shd.params_shardings(
            p, mesh, min_size_fsdp=2 ** 10))
    st = opt.init(p)
    losses = []
    ctx.split_kinds(reset=True)
    for i in range(2):
        batch = _lm_batch(cfg, 10 + i, 8, 16)
        with ctx.mesh_context(mesh):
            p, st, m = step(p, st, i, batch)
        losses.append(float(m["loss"]))
    return p, losses


def serve_tokens(cfg, B, Sq):
    """The prompt (and a vlm's patches, an audio model's frames) that
    ``tp_kinds_world`` serves, as numpy arrays: (tokens, extra)."""
    rng = np.random.default_rng(2)
    tok = rng.integers(0, cfg.vocab_size, (B, Sq)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        extra["frames"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return tok, extra


class _Axes:
    """A cache entry's logical axes, as one leaf of ``core.tree``."""

    def __init__(self, axes):
        self.axes = axes


def tp_kinds_world(rank, world, inp):
    """The layer kinds split over 'model' since the MLP (MoE experts by
    rows and width, MLA heads, Mamba1 channels, Mamba2 heads, decode
    attention heads, the logits) on a (data, model) mesh of
    ``inp["mesh"]``: train steps (``kind_steps``; the MoE's also on a
    mesh of 'model' extent 1 that splits the rows), a capacity-dropping
    MoE's gradients, sharded prefill and decode against the unsharded ones
    computed on each rank (of ``inp["params"]`` where it has the arch),
    the flops of one MoE and one Mamba1 block a rank, the ``ctx`` helpers,
    and the layers bitwise with and without a 'model' extent of 1."""
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import base as cb
    from repro_torch.core import tree as T
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as S
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as TR
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.loop import value_and_grad

    D, Mo = inp["mesh"]
    mesh = mesh_lib.make_local_mesh(D, Mo, "cpu")
    # 'model' extent 1, the rows split over all ranks
    m1 = mesh_lib.make_local_mesh(D * Mo, 1, "cpu")
    kw = dict(min_size_fsdp=2 ** 10)
    # a small upcast bound: an undivided vocabulary's logits then take
    # several chunks (and decode attention several row groups) at smoke size
    L.DECODE_UPCAST_BYTES = 4 * 64 * 100

    def host(x):
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        return None if x is None else x.detach().numpy()

    def placed(p):
        return shd.distribute_tree(p, shd.params_shardings(p, mesh, **kw))

    def steps(arch, on=mesh):
        def run():
            cfg = cb.get_smoke_config(arch)
            ps, ms = kind_steps(cfg, inp["params"][arch], inp["hp"], on)
            return dict(losses=ms, params=[host(t) for t in T.leaves(ps)],
                        kinds=ctx.split_kinds(reset=True))
        return run

    def grads(arch, **over):
        def run():
            cfg = cb.get_smoke_config(arch).with_(**over)
            p = M.init_params(cfg, 0, "cpu")
            batch = _lm_batch(cfg, 1, 4, 16)
            (l0, _), g0 = value_and_grad(
                lambda q: M.loss_fn(q, cfg, batch), p)
            pd = placed(p)
            ctx.split_kinds(reset=True)
            with ctx.mesh_context(mesh):
                rows, axes = ctx.local_rows(batch)
                with ctx.rows_split_over(axes):
                    (l1, _), g1 = value_and_grad(
                        lambda q: M.loss_fn(q, cfg, rows), pd)
            return dict(loss=(float(l0), float(l1)),
                        grads=[host(t) for t in T.leaves(g0)],
                        sharded=[host(t) for t in T.leaves(g1)],
                        kinds=ctx.split_kinds(reset=True))
        return run

    def on_mesh(whole, cfg, kind, B, Sq):
        """``whole`` (a serve batch) as DTensors placed as the dry-run
        places a cell's inputs."""
        axes = cb.input_specs(cfg, cb.ShapeSpec("t", Sq, B, kind),
                              lambda s, dt, ax: _Axes(ax))
        fac = shd.input_sharding_factory(mesh)
        flat = dict(T.flatten_with_path(axes))
        return T.unflatten(whole, [
            shd.distribute(x, shd.NamedSharding(
                mesh, fac(tuple(x.shape), flat[path].axes)))
            for path, x in T.flatten_with_path(whole)])

    def whole_of(local, pls):
        """Outputs of ``local_placements``' placements, whole."""
        pairs = T.flatten_with_path(local)
        return T.unflatten(local, [
            DTensor.from_local(x, mesh, pls[path], run_check=False)
            .full_tensor().numpy() for path, x in pairs])

    def serve(arch, **over):
        """Prefill of 4 x 8 tokens, then two decode steps against a
        16-deep cache, sharded (the cache placed as the dry-run places
        it) and unsharded."""
        def run():
            cfg = cb.get_smoke_config(arch).with_(**over)
            p = None if over else inp["params"].get(arch)
            p = M.init_params(cfg, 0, "cpu") if p is None else p
            ps = placed(p)
            B, Sq = 4, 8
            tok, extra = serve_tokens(cfg, B, Sq)
            tok = torch.from_numpy(tok)
            extra = {k: torch.from_numpy(v) for k, v in extra.items()}
            want = host(M.prefill(p, cfg, tok, extra))
            pre = on_mesh(dict(tokens=tok, **extra), cfg, "prefill", B, Sq)
            ctx.split_kinds(reset=True)
            with ctx.mesh_context(mesh):
                pl = dryrun.local_placements(pre, mesh, cfg)
                rows, axes = dryrun.local_inputs(pre, mesh, cfg)
                with ctx.rows_split_over(axes):
                    got = S.make_prefill_step(cfg)(ps, rows)
            out = dict(prefill=(want, whole_of(dict(tokens=got), pl)
                                ["tokens"]))
            cache = M.init_cache(cfg, B, 16, "cpu")
            pos = torch.zeros(B, dtype=torch.int32)
            with torch.no_grad():
                if cfg.family == "audio":
                    cache.update(TR.encoder_cache(p, cfg, extra["frames"]))
                for t in range(3):
                    _, cache = M.decode_step(p, cfg, tok[:, t:t + 1],
                                             pos + t, cache)
            for t in (3, 4):
                batch = dict(tokens=tok[:, t:t + 1], pos=pos + t,
                             cache=cache)
                with torch.no_grad():
                    wl, wc = M.decode_step(p, cfg, batch["tokens"],
                                           batch["pos"], cache)
                dist_b = on_mesh(batch, cfg, "decode", B, 16)
                with ctx.mesh_context(mesh):
                    pls = dryrun.local_placements(dist_b, mesh, cfg)
                    rows, axes = dryrun.local_inputs(dist_b, mesh, cfg)
                    shapes = {k: (tuple(rows["cache"][k].shape),
                                  tuple(cache[k].shape)) for k in cache}
                    with ctx.rows_split_over(axes):
                        gl, gc = S.make_serve_step(cfg)(ps, rows)
                got = whole_of(dict(tokens=gl, cache=gc), pls)
                out[f"decode{t}"] = dict(
                    logits=(host(wl), got["tokens"]),
                    cache={k: (host(wc[k]), got["cache"][k]) for k in wc},
                    shapes=shapes)
                cache = wc
            out["kinds"] = ctx.split_kinds(reset=True)
            return out
        return run

    def block_flops(kind):
        """Each rank's flops of one MoE (mixtral) or Mamba1 (falcon-mamba)
        block, forward and backward, against the whole block's."""
        def run():
            arch, key, fn = dict(
                moe=("mixtral-8x22b", "moe_blocks", L.moe_apply),
                mamba1=("falcon-mamba-7b", "blocks", None))[kind]
            cfg = cb.get_smoke_config(arch)
            blk = T.tree_map(lambda t: t[0],
                             M.init_params(cfg, 0, "cpu")[key])
            blk = blk["moe"] if kind == "moe" else blk["mamba"]
            on = placed(blk)
            x = torch.randn((4, 16, cfg.d_model),
                            generator=torch.Generator().manual_seed(4))

            def apply(q, xx):
                if kind == "moe":
                    return fn(q, xx, cfg)
                return L.mamba_apply(q, xx, cfg)[0]

            def count(q, mesh_, xx):
                fl = FlopCounterMode(display=False)
                with ctx.mesh_context(mesh_), fl:
                    xx = xx.clone().requires_grad_(True)
                    apply(q, xx).sum().backward()
                return fl.get_total_flops()
            for t in T.leaves(blk) + T.leaves(on):
                t.requires_grad_(True)
            whole = count(blk, None, x)
            with ctx.mesh_context(mesh):
                rows, axes = ctx.local_rows(dict(x=x))
            with ctx.rows_split_over(axes):
                mine = count(on, mesh, rows["x"])
            return dict(whole=whole, rank=mine, ranks=D * Mo)
        return run

    def helpers():
        """``row_share``, ``all_rows(x, parts)`` / ``sum_own_rows``
        (value and gradient), ``model_gather`` and ``model_dim`` on the
        mesh."""
        r = torch.distributed.get_rank()
        x0 = torch.arange(24, dtype=torch.float32).reshape(8, 3)
        with ctx.mesh_context(mesh):
            rows, axes = ctx.local_rows(dict(x=x0))
            with ctx.rows_split_over(axes):
                share = ctx.row_share()
                parts = axes + ("model",)
                x = rows["x"].clone().requires_grad_(True)
                y = ctx.sum_own_rows(ctx.all_rows(x, parts) * (1.0 + r),
                                     parts)
                y.sum().backward()
            gathered = ctx.model_gather(
                torch.full((2, 1), float(ctx.model_rank())), 1)
            sq = torch.zeros(4, 4)
            w = shd.distribute(sq, shd.NamedSharding(mesh, shd.P(None,
                                                                 "model")))
            w0 = shd.distribute(sq, shd.NamedSharding(mesh, shd.P()))
            placed_ = (ctx.model_dim(w), ctx.model_dim(w0))
        return dict(share=share, n=D, x=rows["x"].numpy(), y=host(y),
                    grad=x.grad.numpy(), total=float(sum(
                        1.0 + q for q in range(world))),
                    gathered=gathered.numpy(), tp=Mo, placed=placed_)

    def bitwise():
        """Each layer kind on a mesh of 'model' extent 1 ((D * Mo, 1), the
        rows not split) with its weights DTensors, bitwise its output
        without a mesh; the MoE without a mesh bitwise ``_moe_rows``."""
        gen = torch.Generator().manual_seed(6)
        out = {}
        for arch, key, sub in (("mixtral-8x22b", "moe_blocks", "moe"),
                               ("deepseek-v3-671b", "moe_blocks", "attn"),
                               ("falcon-mamba-7b", "blocks", "mamba"),
                               ("zamba2-7b", "groups", "mamba")):
            cfg = cb.get_smoke_config(arch)
            blk = M.init_params(cfg, 0, "cpu")[key]
            blk = T.tree_map(lambda t: t[0], blk)
            if key == "groups":
                blk = T.tree_map(lambda t: t[0], blk)
            blk = blk[sub]
            on = shd.distribute_tree(blk, shd.params_shardings(blk, m1,
                                                               **kw))
            x = torch.randn((2, 8, cfg.d_model), generator=gen)
            fn = dict(moe=lambda q: L.moe_apply(q, x, cfg, acc_init=x),
                      attn=lambda q: L.mla_apply(q, x, cfg, acc_init=x)[0],
                      mamba=lambda q: (L.mamba2_apply if key == "groups"
                                       else L.mamba_apply)(q, x, cfg)[0])
            plain = fn[sub](blk)
            with ctx.mesh_context(m1):
                got = fn[sub](on)
            out[f"{arch}/{sub}"] = (plain.numpy(), got.numpy())
            if sub == "moe":
                out["moe_rows"] = (plain.numpy(), (L._moe_rows(
                    blk, x, cfg) + x).numpy())
        for name, vdim in (("tied", 0), ("untied", 1)):
            w = torch.randn((96, 64) if vdim == 0 else (64, 96),
                            generator=gen)
            h = torch.randn((2, 1, 64), generator=gen)
            on = shd.distribute_tree(dict(w=w), shd.params_shardings(
                dict(w=w), m1, min_size_fsdp=2 ** 10))["w"]
            plain = L.logits(h, w, vdim, torch.float32)
            want = torch.matmul(h, (w if vdim == 0 else w.T).T)
            with ctx.mesh_context(m1):
                got = L.logits(h, on, vdim, torch.float32)
            out[f"logits/{name}"] = (plain.numpy(), got.numpy(),
                                     want.numpy())
        return out

    pairs = [(f"steps/{a}", steps(a)) for a in inp["params"]]
    pairs += [(f"rows_only/{a}", steps(a, m1)) for a in inp["params"]
              if cb.get_smoke_config(a).num_experts]
    pairs += [("capacity", grads("mixtral-8x22b", moe_capacity_factor=0.28))]
    pairs += [(f"serve/{a}", serve(a.split("/")[0], **over))
              for a, over in inp["serve"].items()]
    pairs += [("flops/moe", block_flops("moe")),
              ("flops/mamba1", block_flops("mamba1")),
              ("helpers", helpers), ("bitwise", bitwise)]
    return checks(pairs)
