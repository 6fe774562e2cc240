"""Design-space enumeration on the H100's own knobs, and the chain planner.

The port's copy of ``repro.tune.space``.  The TPU's knobs (``batch_tile``
over the grid, ``cout_block``, the VMEM budget) are not the port kernels'
knobs: each kernel on the ResNet path picks its decomposition by a rule,
and the tuner makes that decomposition a knob, with the rule as its
default (0):

  * ``conv_stem`` (banded path) and ``resblock_fused``: ``band_rows``,
    the output rows a thread block takes (the rules: ``conv_stem.ops.
    stem_band_rows`` and :func:`block_band_rows`);
  * ``block_chain``: ``split``, the thread blocks an image (the cluster),
    and ``batch_tile``, the images a cluster takes (the rule:
    :func:`chain_split`).

Both block kernels size their warp items from each conv phase's shape
(:func:`warp_tile`, :func:`block_tiles`, :func:`chain_tiles`).  That rule
is not a knob: every tile gives the same bits, and the rule follows from
the band or split the knobs above choose.

A config is legal when it is

  1. **shape-legal**: a band of 1 .. oh rows (only the band heights that
     give a distinct number of bands are enumerated, each the shortest
     that does — a taller band with as many thread blocks only lengthens
     the longest one); a split of 1, 2, 4 or 8 that divides every map
     height of the chain (:func:`chain_splits`); a batch tile that
     divides the batch;
  2. **shared-memory-legal**: one thread block fits :data:`SMEM_BUDGET`
     (``core.dataflow.stem_band_smem_bytes``,
     ``resblock_task_smem_bytes``, ``chain_task_smem_bytes``, the kernels'
     own formulas), the counterpart of the TPU's VMEM cap;
  3. **co-schedulable** (chains, on the card): the card runs at least one
     cluster of that split at that shared memory (``capacity``, the
     kernel's occupancy query ``kernels.megakernel.ops.max_clusters``).

The eq. 12-14 balance pruning (``core.ilp.balanced_och_par``) of the
reference prunes ``cout_block``, the TPU's channel blocking; no Hopper knob
of these kernels blocks channels, so there is nothing for it to prune.

The LM kernels' knobs (``matmul_space``, ``attention_space``,
``scan_space``, ``lm_model_space``): ``matmul_int8``'s tile width ``bn``
and split-K ``split``, ``flash_attention``'s query positions a thread
block ``bm``, ``selective_scan``'s ``(cout_block, lanes)``.  Each config
they return passes the wrapper's own legality check (``matmul_knobs``,
``attn_knobs``, ``scan_knobs``).  There is no LM search (nor in the
reference): a tuning dict is chosen by hand, or timed config by config
(``chip_smoke.py``'s ``lm_tune`` phase).

The chain planner lives here too: :func:`chain_space` (legal batch tiles of
a chain at the rule's split) and :func:`chain_cut_points` (the greedy
longest legal runs), the reference's rule at the H100's budget.

Structure only: nothing here touches weights.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import dataflow
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.matmul_int8 import ops as mm_ops
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.tune.config import DEFAULT, KernelConfig

# Dynamic shared memory one thread block may opt into on an H100 (227 KB;
# ``repro::kMaxSmemBytes`` in ``kernels/csrc/common.cuh``).
SMEM_BUDGET = 232_448
# Thread block cluster sizes the block_chain kernel takes (portable sizes).
SPLITS = (1, 2, 4, 8)


def divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def block_band_rows(oh: int, n: int, sms: int) -> int:
    """Output rows one thread block of ``resblock_fused`` takes, for an
    ``oh``-row output map at batch ``n`` on a card of ``sms`` SMs: the
    tallest bands that give each image at least ``sms // n`` of them (one
    wave of one thread block an SM), or one band a row.  On an H100's 132
    SMs, at bucket 32 the 32-, 16- and 8-row maps get bands of 8, 4 and 2
    rows (128 thread blocks each), at bucket 8 of 2, 1 and 1, at bucket 1
    of 1."""
    parts = max(1, min(oh, sms // max(n, 1)))
    band = -(-oh // parts)
    while band > 1 and -(-oh // band) < parts:
        band -= 1
    return band


# The register tiles of the block kernels' warp items, (MT, NT): MT pixel
# tiles of 16 output pixels by NT channel pairs of 16 output channels
# (block_body.cuh's fixed set, ``with_tile``), in the order
# :func:`warp_tile` prefers them: the largest first and, among tiles of
# one size, the one that loads the fewest fragments a K step (MT + NT),
# then the fewest pixel tiles (no ragged last item).  ``resblock_fused``
# takes every tile; ``block_chain`` those of sides up to 2
# (:data:`CHAIN_TILES`): beside the chain's own state, a tile 4 pixel
# tiles or 4 channel pairs long spills out of the 128 registers a thread
# that its two thread blocks an SM leave.
TILES = ((2, 2), (1, 4), (4, 1), (1, 2), (2, 1), (1, 1))
CHAIN_TILES = tuple(t for t in TILES if max(t) <= 2)
# warps of one thread block of resblock_fused and block_chain (256 threads)
WARPS = 8


def warp_tile(pixels: int, nps: int, warps: int = WARPS,
              tiles=TILES) -> Tuple[int, int]:
    """The register tile (MT, NT) of the warp items of one conv phase of a
    block kernel's thread block: ``pixels`` output pixels (of one image),
    ``nps`` output channel pairs, ``warps`` warps; ``tiles``: the kernel's
    set.  The largest MT * NT with NT dividing ``nps`` that still leaves
    every warp at least one item (``ceil(ceil(pixels / 16) / MT) * nps /
    NT`` items) and does not lengthen the busiest warp's run: its rounds
    of items times MT * NT at most the rounds of (1, 1) items, where
    items that fall unevenly on the warps would leave it longer.  (1, 1)
    where no larger tile does.  A warp then runs MT * NT times fewer
    items in turn, each with 2 MT NT independent accumulator chains."""
    mts = -(-pixels // 16)
    rounds = -(-mts * nps // warps)          # a warp's (1, 1) items
    for mt, nt in tiles:
        if nps % nt:
            continue
        items = -(-mts // mt) * (nps // nt)
        if items >= warps and -(-items // warps) * mt * nt <= rounds:
            return mt, nt
    return 1, 1


def block_tiles(oh: int, ow: int, band: int, cout: int
                ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The tiles of ``resblock_fused``'s two conv phases in a launch of
    ``band``-row bands on an (oh, ow) output map of ``cout`` channels:
    phase A (conv0 over the band and its recomputed halo rows, sized at
    the ``min(band + 1, oh)`` rows of a band at the map's edge, the fewest
    a whole band computes) and phase B (skip + conv1 over the band's
    rows)."""
    nps = -(-cout // 16)
    return (warp_tile(min(band + 1, oh) * ow, nps),
            warp_tile(band * ow, nps))


def chain_tiles(blocks, split: int) -> Tuple[Tuple[int, int], ...]:
    """The tile of each link of a ``block_chain`` launch at ``split``
    thread blocks an image: both conv phases of a link compute the thread
    block's band of the link's output map (``oh / split`` rows) at the
    same output channels, so one tile serves both."""
    return tuple(warp_tile(b.oh // split * b.ow, -(-b.och // 16),
                           tiles=CHAIN_TILES) for b in blocks)


def block_bands(oh: int, band: int) -> List[Tuple[int, int]]:
    """(first row, rows) of each band of ``band`` output rows that
    ``resblock_fused``'s grid takes of an ``oh``-row map, the last one
    ragged."""
    return [(r0, min(band, oh - r0)) for r0 in range(0, oh, band)]


def block_band_input_rows(r0: int, band: int, stride: int) -> Tuple[int,
                                                                    int]:
    """[lo, hi): the rows of the SAME-padded input that the thread block of
    the band at ``r0`` stages (``xrows`` in ``csrc/resblock_fused.cu``):
    every row that conv0 reads for y0 rows ``r0 - 1 .. r0 + band`` (the band
    and one recomputed row either side) and that the skip reads.  Rows
    outside the padded input are staged as zeros."""
    return (r0 - 1) * stride, (r0 + band) * stride + 3


def chain_bands(h: int, split: int) -> List[Tuple[int, int]]:
    """(first row, rows) of each of the ``split`` equal row bands of an
    ``h``-row map that ``block_chain``'s cluster ranks own."""
    nb = h // split
    return [(r * nb, nb) for r in range(split)]


def chain_splits(blocks) -> List[int]:
    """The splits the ``block_chain`` kernel can take for a chain: cluster
    sizes of 1, 2, 4 or 8 thread blocks an image that divide the height
    of every map of the chain, so that every band has the same rows and a
    stride-2 link's output band r reads exactly input band r."""
    heights = [b.h for b in blocks] + [b.oh for b in blocks]
    return [s for s in SPLITS if all(h % s == 0 for h in heights)]


def chain_split(blocks, tiles: int, batch_tile: int = 1, stem_och: int = 0,
                smem_budget: int = SMEM_BUDGET, capacity=None) -> int:
    """Thread blocks an image (the cluster size) of one ``block_chain``
    launch of ``tiles`` image tiles of ``batch_tile``, among the legal
    splits whose thread block fits ``smem_budget``.  ``capacity(split,
    smem)`` is how many clusters the card runs at once
    (``kernels.megakernel.ops.max_clusters``, the kernel's own occupancy
    query): the launch takes the largest split whose ``tiles`` clusters
    run in one wave, or the smallest when none does.  Without it (the
    planner, which judges legality at batch 1) the largest split.  When no
    split fits the budget, the largest, whose planes are smallest.  The
    one place the split is chosen; ``KernelConfig.batch_tile`` keeps its
    meaning."""
    smem = {s: dataflow.chain_task_smem_bytes(blocks, batch_tile,
                                              stem_och=stem_och, split=s)
            for s in chain_splits(blocks)}
    fits = [s for s, b in smem.items() if b <= smem_budget]
    if not fits or capacity is None:
        return max(fits or smem)
    wave = [s for s in fits if tiles <= capacity(s, smem[s])]
    return max(wave) if wave else min(fits)


def chain_space(blocks, batch: int, stem_och: int = 0,
                smem_budget: int = SMEM_BUDGET) -> List[KernelConfig]:
    """Legal batch tilings for one block-chain kernel (``blocks`` is a list
    of :class:`~repro_torch.core.dataflow.BlockShape` chain links, in order;
    ``stem_och > 0`` fuses the stem at the head).  A tile is legal when one
    thread block fits the shared-memory budget at the split
    :func:`chain_split` picks for it.  A chain whose thread block exceeds
    the budget at *every* batch tile cannot run — the empty list tells the
    planner to cut it shorter.  Channel blocking is fusion-illegal, as for
    the single fused block."""
    out = []
    for bt in divisors(batch):
        split = chain_split(blocks, batch // bt, bt, stem_och, smem_budget)
        smem = dataflow.chain_task_smem_bytes(blocks, bt, stem_och=stem_och,
                                              split=split)
        if smem <= smem_budget:
            out.append(KernelConfig(batch_tile=bt))
    return out


def chain_cut_points(blocks, batch: int, stem_och: int = 0,
                     smem_budget: int = SMEM_BUDGET) -> List[List[int]]:
    """Greedy longest-legal partition of a model's block sequence into
    chains: extend the open chain while :func:`chain_space` still has a
    legal tiling, else cut.  ``blocks`` is the whole-model
    ``dataflow.resnet_block_shapes`` list; returns lists of block indices.
    Any partition into runs of consecutive blocks is *arithmetically* legal
    (the chain-cut property); this picks the one with the fewest interior
    boundaries through HBM under the shared-memory cap."""
    cuts, open_chain = [], []
    for i, _ in enumerate(blocks):
        cand = open_chain + [i]
        och = stem_och if (not cuts and cand[0] == 0) else 0
        if chain_space([blocks[j] for j in cand], batch, stem_och=och,
                       smem_budget=smem_budget):
            open_chain = cand
            continue
        if open_chain:
            cuts.append(open_chain)
        # a single block over budget still has to run somewhere: emit it as
        # a singleton chain (the backend runs it through resblock_fused)
        open_chain = [i]
    if open_chain:
        cuts.append(open_chain)
    return cuts


# ---------------------------------------------------------------------------
# The tuner's spaces: legal configs per task of the lowering plan
# ---------------------------------------------------------------------------


def band_choices(oh: int) -> List[int]:
    """Band heights of an ``oh``-row map that give a distinct number of
    bands, each the shortest that does, tallest first: ``ceil(oh / k)`` for
    k = 1 .. oh.  For 32 rows: 32, 16, 11, 8, 7, 6, 5, 4, 3, 2, 1."""
    return sorted({-(-oh // k) for k in range(1, oh + 1)}, reverse=True)


def stem_space(layer: dataflow.ConvLayer, batch: int,
               smem_budget: int = SMEM_BUDGET) -> List[KernelConfig]:
    """Legal ``band_rows`` of ``conv_stem``'s banded path for the stem
    ``layer`` (at any batch: a thread block takes one image's band).

    Stands in for the TPU stem's ``batch_tile`` (images a grid step) and
    ``cout_block`` (channel blocks a grid step).  Neither has a
    counterpart: a thread block takes a band of one image, and the banded
    stem computes 16 output channels a thread in one pass, so there is
    no channel blocking, and no balance floor (eq. 12-14) to prune by."""
    del batch
    if not (1 <= layer.ich <= 4 and layer.och % 16 == 0):
        return []                     # the general path has no band knob
    return [KernelConfig(band_rows=b) for b in band_choices(layer.oh)
            if dataflow.stem_band_smem_bytes(b, layer.iw, layer.ich,
                                             layer.och) <= smem_budget]


def block_space(layer0: dataflow.ConvLayer, batch: int,
                downsample: bool = False,
                smem_budget: int = SMEM_BUDGET) -> List[KernelConfig]:
    """Legal ``band_rows`` of ``resblock_fused`` for one residual block
    (``layer0`` is the block's conv0 row of ``dataflow.resnet_layers``).

    Stands in for the TPU block's ``batch_tile`` (images a grid step).
    ``batch_tile`` itself has no counterpart here: a thread block takes a
    band of one image, by design, so the card fills with bands, not
    images.  ``cout_block`` is fusion-illegal, as in the reference (conv1
    consumes all of conv0's channels).  Every band stages ``(band + 1) *
    stride + 3`` input rows and recomputes two rows of y0, so short bands
    cost shared memory and halo traffic."""
    del batch
    return [KernelConfig(band_rows=b) for b in band_choices(layer0.oh)
            if dataflow.resblock_task_smem_bytes(
                layer0.ih, layer0.iw, layer0.ich, layer0.och, layer0.stride,
                downsample, b) <= smem_budget]


def chain_tilings(blocks, batch: int, stem_och: int = 0,
                  smem_budget: int = SMEM_BUDGET,
                  capacity: Optional[Callable] = None) -> List[KernelConfig]:
    """Legal ``(batch_tile, split)`` pairs of one ``block_chain`` launch
    on ``batch`` images: a tile dividing the batch, a split of
    :func:`chain_splits`, one thread block within ``smem_budget`` and, with
    ``capacity(split, smem)`` (the card's occupancy query), at least one
    cluster the card runs at once.

    Stands in for the TPU chain's ``batch_tile`` (images a grid step, the
    pinned weights amortised over them): here a cluster of ``split``
    thread blocks takes ``batch_tile`` images, restaging every link's
    weights once per cluster rank, so a larger tile trades fewer weight
    restages for fewer thread blocks."""
    out = []
    for s in chain_splits(blocks):
        for bt in divisors(batch):
            smem = dataflow.chain_task_smem_bytes(blocks, bt,
                                                  stem_och=stem_och, split=s)
            if smem > smem_budget:
                continue
            if capacity is not None and capacity(s, smem) < 1:
                continue
            out.append(KernelConfig(batch_tile=bt, split=s))
    return out


@functools.lru_cache(maxsize=None)
def model_chains(cfg, smem_budget: int = SMEM_BUDGET
                 ) -> Tuple[Tuple[str, Tuple[int, ...], int], ...]:
    """The chains ``cuda-stream`` runs for ``cfg`` by default
    (``compile.lowering.plan_chains`` with no cuts and the stem fused where
    it fits): ``(key, block indices, stem_och)`` each, ``key`` the tuning
    key of the chain's head node (``"stem"`` when the stem is fused, else
    ``"block{i}"``), whose config the chain reads."""
    from repro_torch.compile import lowering   # lowering imports tune

    plan = lowering.plan_model(lowering.optimized_graph(cfg))
    return tuple(
        ("stem" if c.stem is not None else f"block{c.blocks[0].index}",
         tuple(t.index for t in c.blocks),
         cfg.base_width if c.stem is not None else 0)
        for c in lowering.plan_chains(plan, cfg, smem_budget=smem_budget))


def model_space(cfg, batch: int, backend: str = "cuda",
                smem_budget: int = SMEM_BUDGET,
                capacity: Optional[Callable] = None
                ) -> Dict[str, List[KernelConfig]]:
    """Per-task legal configs for a ResNetConfig at one batch bucket on a
    kernel backend, one thread block within ``smem_budget``.

    Keys are the plan's tuning keys (``compile.lowering.tuning_key``).
    ``cuda``: ``"stem"`` (:func:`stem_space`) and ``"block{i}"``
    (:func:`block_space`).  ``cuda-stream``: one key per chain of the
    backend's plan (:func:`model_chains`; :func:`chain_tilings`, but a
    chain cut down to one block without the stem runs ``resblock_fused``,
    so its key gets :func:`block_space`), and ``"stem"`` when the stem
    runs alone.  Every returned config is bitwise with the default by the
    kernel contract (held config by config in tests/test_torch_tune.py)."""
    layers = {l.name: l for l in dataflow.resnet_layers(
        cfg.blocks_per_stage, cfg.base_width, cfg.img)}

    def block(i):
        return block_space(layers[f"c{i}_0"], batch,
                           downsample=f"ds{i}" in layers,
                           smem_budget=smem_budget)

    if backend == "cuda":
        spaces = {"stem": stem_space(layers["stem"], batch, smem_budget)}
        for i in range(3 * cfg.blocks_per_stage):
            spaces[f"block{i}"] = block(i)
        return spaces
    if backend != "cuda-stream":
        raise ValueError(f"model_space: the kernel backends are 'cuda' and "
                         f"'cuda-stream', not {backend!r}")
    shapes = dataflow.resnet_block_shapes(cfg.blocks_per_stage,
                                          cfg.base_width, cfg.img)
    chains = model_chains(cfg)
    spaces = {} if chains[0][2] else \
        {"stem": stem_space(layers["stem"], batch, smem_budget)}
    for key, run, stem_och in chains:
        if len(run) == 1 and not stem_och:
            spaces[key] = block(run[0])
        else:
            spaces[key] = chain_tilings([shapes[i] for i in run], batch,
                                        stem_och, smem_budget, capacity)
    return spaces


# ---------------------------------------------------------------------------
# The LM kernels' spaces
# ---------------------------------------------------------------------------

# query positions a thread block of flash_attention takes, widest first
ATTN_POSITIONS = (64, 32, 16, 8, 4, 2, 1)


def matmul_space(M: int, K: int, N: int,
                 acc_init: bool = False) -> List[KernelConfig]:
    """Legal ``(bn, split)`` of ``matmul_int8``'s wgmma path for an (M, K)
    @ (K, N) product: every tile width up to the narrowest that covers N
    (widest first) times every legal split-K (:func:`~repro_torch.kernels.
    matmul_int8.ops.k_splits`).  Empty on a shape that takes the
    ``mma_sync`` path, which has no knobs.  Stands in for the reference's
    (bm, bn, bk) MXU tilings: the 128 x 128 block tile is fixed here."""
    del acc_init          # the init is read whatever the tiles
    if mm_ops.matmul_path(M, N, K) != "wgmma":
        return []
    out = [KernelConfig(bn=bn, split=split)
           for bn in reversed(mm_ops.tile_widths(N))
           for split in mm_ops.k_splits(K)]
    for c in out:
        mm_ops.matmul_knobs(M, N, K, c)       # legal by the wrapper's check
    return out


def attention_space(Sq: int, Sk: int, head_dim: int,
                    group: int = 1) -> List[KernelConfig]:
    """Legal ``bm`` of ``flash_attention`` (the query positions one thread
    block takes; it takes ``min(group, 64 // bm)`` heads of a kv group),
    widest first, for ``group`` query heads a kv head.  Empty where the
    kernel does not take ``head_dim`` (a multiple of 16, at most 256).
    Stands in for the reference's (bq, bk) pairs: the K/V tile is fixed
    at 64 keys here."""
    del Sq, Sk            # a ragged last tile is masked, any bm is legal
    if head_dim % 16 or head_dim > flash_ops.MAX_HEAD_DIM:
        return []
    out = [KernelConfig(bm=p) for p in ATTN_POSITIONS]
    for c in out:
        flash_ops.attn_knobs(group, c)
    return out


def scan_space(seq_len: int, d_inner: int,
               ssm_state: int) -> List[KernelConfig]:
    """Legal ``(cout_block, lanes)`` of ``selective_scan``: every pair the
    kernel is instantiated at (``ops.SHAPES``), for a state of at most 16.
    ``cout_block`` is the reference's ``bd`` knob, so a reference-style
    ``{"cout_block": 16}`` means the same here."""
    del seq_len, d_inner  # the grid masks a ragged channel block
    if ssm_state > scan_ops.MAX_STATE:
        return []
    out = [KernelConfig(cout_block=c, lanes=l) for c, l in scan_ops.SHAPES]
    for c in out:
        scan_ops.scan_knobs(c)
    return out


def lm_task_dims(cfg) -> Dict[str, Tuple[int, int]]:
    """``{role: (din, dout)}`` of one layer's projections of an LM config
    (``compile.lm_params.QLMConfig``)."""
    if cfg.family == "dense":
        qkv = cfg.num_heads * cfg.head_dim
        kv = cfg.num_kv_heads * cfg.head_dim
        return dict(wq=(cfg.d_model, qkv), wk=(cfg.d_model, kv),
                    wv=(cfg.d_model, kv), wo=(qkv, cfg.d_model),
                    up=(cfg.d_model, cfg.d_ff),
                    down=(cfg.d_ff, cfg.d_model))
    return dict(wu=(cfg.d_model, cfg.d_inner), wz=(cfg.d_model, cfg.d_inner),
                wdt=(cfg.d_model, cfg.d_inner),
                wb=(cfg.d_model, cfg.ssm_state),
                wc=(cfg.d_model, cfg.ssm_state),
                wo=(cfg.d_inner, cfg.d_model))


def lm_model_space(cfg, batch: int) -> Dict[str, List[KernelConfig]]:
    """Per-task legal configs for an LM config at one batch bucket.  Keys
    match ``lowering.tuning_key`` (``layer{i}/{role}`` for every matmul,
    attention and scan task of the optimized graph), the reference's key
    set.  Matmul M is the flattened token count (``batch * seq_len``)."""
    M = batch * cfg.seq_len
    spaces: Dict[str, List[KernelConfig]] = {}
    for i in range(cfg.num_layers):
        if cfg.family == "dense":
            spaces[f"layer{i}/attn"] = attention_space(
                cfg.seq_len, cfg.seq_len, cfg.head_dim,
                cfg.num_heads // cfg.num_kv_heads)
        else:
            spaces[f"layer{i}/scan"] = scan_space(
                cfg.seq_len, cfg.d_inner, cfg.ssm_state)
        for role, (din, dout) in lm_task_dims(cfg).items():
            spaces[f"layer{i}/{role}"] = matmul_space(
                M, din, dout, acc_init=role in ("wo", "down"))
    return spaces


def lm_task_knobs(cfg, batch: int, key: str, config=None) -> tuple:
    """The knobs the kernel of LM task ``key`` resolves ``config`` to at
    bucket ``batch``: ``(bn, split)``, ``(heads, positions)`` or
    ``(channels, lanes)``, by the wrappers' own checks."""
    role = key.split("/", 1)[1]
    if role == "attn":
        return flash_ops.attn_knobs(cfg.num_heads // cfg.num_kv_heads,
                                    config)
    if role == "scan":
        return scan_ops.scan_knobs(config)
    din, dout = lm_task_dims(cfg)[role]
    return mm_ops.matmul_knobs(batch * cfg.seq_len, dout, din, config)


def lm_tuned_variant(cfg, batch: int) -> Dict[str, KernelConfig]:
    """A deliberately non-default, legal LM tuning: for each task of
    :func:`lm_model_space`, the first config of its space whose knobs
    resolve to other values than the kernel's rule (tasks whose space has
    none are left out).  The port's counterpart of the reference's
    ``tests/test_conformance.py:lm_tuned_variant``, on the H100's knobs."""
    out = {}
    for key, space in lm_model_space(cfg, batch).items():
        rule = lm_task_knobs(cfg, batch, key, DEFAULT)
        c = next((c for c in space
                  if lm_task_knobs(cfg, batch, key, c) != rule), None)
        if c is not None:
            out[key] = c
    return out


def space_size(spaces: Dict[str, List[KernelConfig]]) -> int:
    """Cardinality of the joint design space (product over tasks) — what an
    exhaustive search would have to time on the card."""
    total = 1
    for cands in spaces.values():
        total *= max(1, len(cands))
    return total
