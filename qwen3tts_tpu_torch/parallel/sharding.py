"""Device-mesh sharding over ``torch.distributed``: TP (and DP) serving.

Port of the serving half of ``qwen3tts_tpu/parallel/sharding.py``, with its
names.  In JAX, sharding is a layout: ``shard_params`` puts each leaf under
a ``NamedSharding`` and XLA inserts the collectives.  Here every rank is a
process that holds its own shard, and the model calls each collective by
hand (``parallel/collectives.py``, given ``Mesh.tp_group``), megatron-style:

- column-parallel ``qkv_proj`` and ``gateup_proj``, split per part, never
  as one contiguous slice: rank r takes its q heads, k heads and v heads,
  ``[q_r | k_r | v_r]``, and ``[gate_r | up_r]`` (``P.parts``);
- row-parallel ``o_proj`` and ``down_proj``, whose input rows split the
  same way, each product all-reduced before its residual add;
- the KV cache ``[L, B, S, KVH, D]`` and its int8 scale planes ``[L, B,
  KVH, S]`` split by kv head, so every cache write and read stays local;
- the embeddings and heads as ``talker_param_specs`` /
  ``predictor_param_specs`` say (``models/talker.py``,
  ``models/predictor.py``): a lookup then an all-gather on a split hidden
  axis, an all-gather of logits on a split vocabulary, a masked lookup
  then an all-reduce on split vocabulary rows.

``launch(fn, world, *args)`` spawns ``world`` processes, joins them into a
process group over TCP on this host and runs ``fn(mesh, *args)`` in each:
over NCCL one card a rank, and it raises when there are fewer cards than
ranks; over gloo on the CPU (``device="cpu"``) or, every rank on the first
card, with ``device="cuda", backend="gloo"``.  It never picks gloo or the
CPU for itself.  The spawned ranks import the port only.  Its NCCL ranks
start with ``NCCL_GRAPH_MIXING_SUPPORT=0``, so that a captured chunk holds
the collectives inside each step's conditional node (``runtime/engine.py``).

The checks run the Engine's serving path on every rank of a mesh, sharded,
and the same computation unsharded on global rank 0, as the JAX checks do:
``sharded_inference_check`` and ``sharded_batched_serving_check`` on a
tiny shardable config, ``sharded_flagship_check`` and
``sharded_flagship_structural_check`` on a preset (the 0.6B by default).
Each takes ``params`` (numpy or torch, as the JAX package's initialisers
make them, so that a test can run both packages on one set of weights).

The training half: ``_talker_loss`` (the codec head's cross entropy
against next-frame codebook-0 targets, JAX's ``sharding.py:519-535``) and
``make_train_step(cfg, mesh, learning_rate)`` -> ``(init_opt,
train_step)``, one AdamW step (``utils/optim.py:adamw``, optax's numbers)
on this rank's shard.  Autograd sees the collectives through
``parallel/collectives.py``'s ``copy_to_tp`` / ``reduce_from_tp`` /
``gather_from_tp``; what XLA sums by itself is written here: the loss is
the masked mean over the whole mesh's batch, the gradients are summed over
the dp group, and those of ``q_norm`` / ``k_norm`` (whole on every rank,
applied to the rank's own heads only) over the tp group.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import os
import queue as queue_lib
import socket
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import PredictorConfig, TalkerConfig, TTSModelConfig
from ..core.loader import resolve_device
from ..core.presets import get_preset
from ..models import predictor as predictor_lib
from ..models import talker as talker_lib
from ..models.layers import prefill_mask, rms_norm, stack_forward
from ..ops import flash_decode as flash_lib
from ..runtime import loops
from ..runtime.engine import Engine, GenerationPolicy, upload
from ..utils import optim
from . import collectives

# ---------------------------------------------------------------------------
# the mesh and the launcher
# ---------------------------------------------------------------------------


def mesh_layout(n: int, dp: Optional[int] = None, tp: Optional[int] = None
                ) -> Tuple[Dict[str, int], List[List[int]], List[List[int]]]:
    """(shape ``{"dp", "tp"}``, the tp groups, the dp groups) of ``n``
    ranks, by JAX's rules for defaults (all ranks on tp when neither is
    given).  Rank ``r`` sits at mesh coordinate ``(r // tp, r % tp)``, as
    ``np.array(devices).reshape(dp, tp)`` lays devices out: a tp group is a
    row, a dp group a column."""
    if dp is None and tp is None:
        dp, tp = 1, n
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n or dp < 1 or tp < 1:
        raise ValueError(f"mesh dp {dp} x tp {tp} does not cover {n} ranks")
    tp_groups = [[d * tp + t for t in range(tp)] for d in range(dp)]
    dp_groups = [[d * tp + t for d in range(dp)] for t in range(tp)]
    return {"dp": dp, "tp": tp}, tp_groups, dp_groups


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (dp, tp) mesh of processes: its groups along
    each axis, its device and the backend that joins them."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    backend: str
    tp_group: Any
    dp_group: Any

    @property
    def tp_rank(self) -> int:
        return self.rank % self.shape["tp"]

    @property
    def dp_rank(self) -> int:
        return self.rank // self.shape["tp"]


def _resolved(device) -> torch.device:
    """``resolve_device``'s answer, a card with its index."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, device=None) -> Mesh:
    """The (dp, tp) mesh over the initialised process group (``launch``
    initialises it); every rank must call it.  ``device`` defaults to the
    current card, whatever the backend; with no card that raises, and the
    CPU must be asked for (``device="cpu"``)."""
    device = _resolved(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised (launch does it)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}")
    shape, tp_groups, dp_groups = mesh_layout(n, dp, tp)
    rank = dist.get_rank()
    backend = dist.get_backend()
    groups = {}
    for axis, layout in (("tp", tp_groups), ("dp", dp_groups)):
        for ranks in layout:  # every rank creates every group, in one order
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh(shape, rank, device, backend, groups["tp"], groups["dp"])


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, backend: str, on_cuda: bool, dp, tp, fn,
            args, results) -> None:
    # one intra-op thread a rank: several ranks (and test workers) share the host
    torch.set_num_threads(1)
    if backend == "nccl":
        # NCCL's graph-mixing support records events into a captured graph,
        # and a conditional node's body (each captured step) takes none
        os.environ.setdefault("NCCL_GRAPH_MIXING_SUPPORT", "0")
    try:
        device = torch.device("cpu")
        if on_cuda:
            device = torch.device("cuda", rank if backend == "nccl" else 0)
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
            timeout=datetime.timedelta(minutes=10),
            **({"device_id": device} if backend == "nccl" else {}))
        out = fn(make_mesh(world, dp=dp, tp=tp, device=device), *args)
    except Exception:
        # the launcher raises this and ends the other ranks, which may wait
        # in a collective for this one: no orderly teardown here
        results.put(("error", rank, traceback.format_exc()))
        return
    results.put(("ok", rank, out if rank == 0 else None))
    # free what fn left in reference cycles (an Engine and its captured
    # graphs, which hold NCCL's plans) before the communicators go
    gc.collect()
    if on_cuda:
        torch.cuda.synchronize()
    dist.destroy_process_group()


def launch(fn, world: int, *args, device: Optional[str] = None,
           backend: Optional[str] = None, dp: Optional[int] = None,
           tp: Optional[int] = None, timeout: float = 3600.0):
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks of a (dp, tp) mesh
    (``mesh_layout``'s defaults: all on tp) and return rank 0's result,
    which must pickle (return host values, not card tensors).  ``fn`` and
    ``args`` are pickled to the ranks, ``fn`` by its module and name.

    - ``device=None``: NCCL, rank r on card r; raises when there are fewer
      cards than ranks (never falls back to gloo or the CPU);
    - ``device="cpu"``: gloo on the CPU;
    - ``device="cuda", backend="gloo"``: gloo, every rank on card 0 (gloo
      moves the card's tensors through the host; NCCL puts no two ranks on
      one card).

    A rank that raises makes ``launch`` raise with its traceback after the
    other ranks are ended."""
    if device == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"device='cpu' runs over gloo, not {backend}")
        backend, on_cuda = "gloo", False
    elif device in (None, "cuda") and backend in (None, "nccl"):
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < world:
            raise RuntimeError(
                f"launch: {world} ranks over NCCL need {world} cards, one a rank; this "
                f"machine has {cards}.  Ask for device=\"cpu\" or device=\"cuda\", "
                'backend="gloo" explicitly')
        backend, on_cuda = "nccl", True
    elif device == "cuda" and backend == "gloo":
        if not torch.cuda.is_available():
            raise RuntimeError("launch: device='cuda' needs a card")
        on_cuda = True
    else:
        raise ValueError(f"launch: no layout for device={device!r}, backend={backend!r}")
    import torch.multiprocessing as mp  # its pickler shares CPU tensors in args

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world, port, backend, on_cuda, dp, tp, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    try:
        out, reported = None, set()
        while len(reported) < world:
            try:
                status, rank, value = results.get(timeout=1.0)
            except queue_lib.Empty:
                for r, p in enumerate(procs):  # exit code 0: its report is on its way
                    if r not in reported and p.exitcode not in (None, 0):
                        raise RuntimeError(f"launch: rank {r} exited with code {p.exitcode} "
                                           "before it reported") from None
                if time.time() > deadline:
                    raise TimeoutError(f"launch: ranks {sorted(set(range(world)) - reported)} "
                                       f"did not report within {timeout} s") from None
                continue
            if status == "error":
                raise RuntimeError(f"launch: rank {rank} of {world} failed:\n{value}")
            reported.add(rank)
            if rank == 0:
                out = value
        # every rank has reported: a rank still tearing its process group
        # down after that (NCCL ranks have hung there on four cards) is ended
        end = time.time() + 30
        for p in procs:
            p.join(timeout=max(0.0, end - time.time()))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)


# ---------------------------------------------------------------------------
# parameter partition specs
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec, as JAX's ``PartitionSpec``: one entry per axis of a
    leaf, ``None`` (whole on every rank) or ``"tp"`` (split over the mesh's
    tp axis).  ``parts`` gives the sizes of a fused leaf's parts along its
    tp axis (``qkv_proj``: q, k, v; ``gateup_proj``: gate, up): each part
    is split on its own, and a rank's shard is its slices of the parts,
    concatenated."""

    def __new__(cls, *axes, parts: Optional[Tuple[int, ...]] = None):
        spec = super().__new__(cls, axes)
        spec.parts = None if parts is None else tuple(parts)
        return spec


def _block_specs(q_dim: int, kv_dim: int, intermediate: int) -> Dict[str, P]:
    return {
        "input_norm": P(None, None),
        "qkv_proj": P(None, None, "tp", parts=(q_dim, kv_dim, kv_dim)),
        "o_proj": P(None, "tp", None),
        "q_norm": P(None, None),
        "k_norm": P(None, None),
        "post_norm": P(None, None),
        "gateup_proj": P(None, None, "tp", parts=(intermediate, intermediate)),
        "down_proj": P(None, "tp", None),
    }


def refuse_hybrid(cfg: TalkerConfig) -> None:
    """Tensor parallelism and training cover the Qwen3 talker: the hybrid
    LFM2 talker (``models/lfm2.py``) raises."""
    if cfg.is_hybrid:
        raise ValueError("the hybrid LFM2 talker has no tensor-parallel layout and no "
                         "train step: it runs unsharded, for inference")


def talker_param_specs(cfg: TalkerConfig) -> Dict[str, Any]:
    """Specs for the talker's parameters (megatron-style TP): column-parallel
    qkv / gate|up, row-parallel o / down; the collectives are the model's
    (``models/talker.py``)."""
    refuse_hybrid(cfg)
    return {
        "codec_embedding": P(None, "tp"),
        "text_embedding": P(None, "tp"),
        "text_projection": {"w": P("tp", None), "b": P(None)},
        "blocks": _block_specs(cfg.num_attention_heads * cfg.head_dim,
                               cfg.num_key_value_heads * cfg.head_dim,
                               cfg.intermediate_size),
        "final_norm": P(None),
        "codec_head": P(None, "tp"),
        "spk_proj": {"w": P(None, "tp"), "b": P("tp")},
    }


def predictor_param_specs(cfg: PredictorConfig) -> Dict[str, Any]:
    """Specs for the code predictor's parameters (the same TP layout; each
    codebook's head and embedding table split on its vocabulary)."""
    return {
        "small_to_mtp": {"w": P(None, None), "b": P(None)},
        "blocks": _block_specs(cfg.num_attention_heads * cfg.head_dim,
                               cfg.num_key_value_heads * cfg.head_dim,
                               cfg.intermediate_size),
        "final_norm": P(None),
        "lm_heads": P(None, None, "tp"),          # [NC, Hp, CB]
        "codec_embeddings": P(None, "tp", None),  # [NC, CB, Ht]
    }


def _map(tree, specs, fn, path: str = ""):
    """``fn(leaf, spec, path)`` over a parameter tree and its specs, which
    must have the same keys.  A quantized leaf (a dict where the spec has a
    leaf) raises."""
    if isinstance(specs, P):
        if isinstance(tree, dict):
            raise ValueError(f"{path}: a quantized leaf ({sorted(tree)}) cannot be sharded: "
                             "shard_params splits float leaves only")
        return fn(tree, specs, path)
    if not isinstance(tree, dict) or set(tree) != set(specs):
        keys = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path or 'params'}: keys {keys} do not match the specs' "
                         f"{sorted(specs)}")
    return {k: _map(tree[k], specs[k], fn, f"{path}/{k}" if path else k) for k in tree}


def _parts(spec: P, n: int, tp: int, path: str) -> List[Tuple[int, int]]:
    """(offset, size) of each part along a leaf's tp axis of length ``n``."""
    sizes = spec.parts or (n,)
    if sum(sizes) != n:
        raise ValueError(f"{path}: parts {sizes} do not add up to the axis's {n}")
    out, off = [], 0
    for size in sizes:
        if size % tp:
            raise ValueError(f"{path}: a part of {size} does not split {tp} ways")
        out.append((off, size))
        off += size
    return out


def _tensor(x) -> torch.Tensor:
    """A tensor as it is; a numpy array copied (JAX hands out read-only ones)."""
    return torch.tensor(x) if isinstance(x, np.ndarray) else x


def _leaf(x, spec: P, path: str) -> torch.Tensor:
    x = _tensor(x)
    if x.dim() != len(spec):
        raise ValueError(f"{path}: a leaf of {x.dim()} axes under a spec of {len(spec)}")
    return x


def shard_params(params: Dict, mesh: Mesh, specs: Dict) -> Dict:
    """This rank's shard of every leaf (numpy or torch) on ``mesh.device``:
    a ``"tp"`` axis keeps slice ``mesh.tp_rank`` of ``tp`` of each part;
    other leaves are whole."""
    tp, r = mesh.shape["tp"], mesh.tp_rank

    def shard(x, spec, path):
        x = _leaf(x, spec, path)
        if "tp" not in spec:
            return x.to(mesh.device)
        axis = spec.index("tp")
        pieces = [x.narrow(axis, off + r * (size // tp), size // tp)
                  for off, size in _parts(spec, x.shape[axis], tp, path)]
        return torch.cat(pieces, axis).to(mesh.device)

    return _map(params, specs, shard)


def gather_params(params: Dict, mesh: Mesh, specs: Dict) -> Dict:
    """The inverse of ``shard_params``: every leaf whole again, all-gathered
    over the tp group (every rank of it must call)."""
    tp = mesh.shape["tp"]

    def gather(x, spec, path):
        x = _leaf(x, spec, path)
        if "tp" not in spec:
            return x
        axis = spec.index("tp")
        local = x.shape[axis]
        ranks = collectives.all_gather(x, mesh.tp_group, dim=axis).split(local, dim=axis)
        pieces = []
        for off, size in _parts(spec, local * tp, tp, path):
            pieces += [b.narrow(axis, off // tp, size // tp) for b in ranks]
        return torch.cat(pieces, axis)

    return _map(params, specs, gather)


def kv_cache_spec() -> P:
    """KV cache [L, B, S, KVH, D]: the kv heads over tp, as the
    column-parallel qkv projection makes them, so that cache writes and
    reads stay on each rank."""
    return P(None, None, None, "tp", None)


def kv_cache_specs(kv_quant: bool = False) -> Dict[str, P]:
    """Specs of every leaf of the KV cache; with ``kv_quant`` the int8 rows
    as the float cache and the f32 scale planes [L, B, KVH, S] on their kv
    head axis (a scale is per (slot, head): each rank owns its heads')."""
    spec = {"k": kv_cache_spec(), "v": kv_cache_spec()}
    if kv_quant:
        spec["ks"] = P(None, None, "tp", None)
        spec["vs"] = P(None, None, "tp", None)
    return spec


def shard_kv_cache(kv: Dict, mesh: Mesh) -> Dict:
    """This rank's kv heads of a KV cache (float, or int8 with scales)."""
    return shard_params(kv, mesh, kv_cache_specs(kv_quant="ks" in kv))


# ---------------------------------------------------------------------------
# sharded inference checks (every rank of the mesh calls them)
# ---------------------------------------------------------------------------


def _shardable_cfg() -> TTSModelConfig:
    """Tiny but shardable: kv heads, ffn and vocabularies divide by 2 and 4
    (``qwen3tts_tpu/parallel/sharding.py:149-161``)."""
    return TTSModelConfig(
        dtype="float32",
        talker=TalkerConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=4, head_dim=16, intermediate_size=128,
            mrope_section=(4, 2, 2), vocab_size=3072, text_vocab_size=512,
            text_hidden_size=64, speaker_embed_dim=64,
        ),
        predictor=PredictorConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=4, head_dim=16, intermediate_size=128,
        ),
    )


def _host(tree, dtype: torch.dtype):
    """A parameter tree of numpy arrays or tensors as CPU tensors in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _host(v, dtype) for k, v in tree.items()}
    return _tensor(tree).to("cpu", dtype)


def _placed(tree, device):
    if isinstance(tree, dict):
        return {k: _placed(v, device) for k, v in tree.items()}
    return tree.to(device)


def _params(cfg: TTSModelConfig, params, mesh: Mesh, shard: bool):
    """(talker, predictor) on ``mesh.device``: this rank's shards, or whole."""
    tparams, pparams = params
    if not shard:
        return _placed(tparams, mesh.device), _placed(pparams, mesh.device)
    return (shard_params(tparams, mesh, talker_param_specs(cfg.talker)),
            shard_params(pparams, mesh, predictor_param_specs(cfg.predictor)))


def _tiny_params(cfg: TTSModelConfig, params):
    if params is not None:
        return _host(params[0], torch.float32), _host(params[1], torch.float32)
    return (talker_lib.init_params(torch.Generator().manual_seed(0), cfg.talker,
                                   torch.float32, "cpu"),
            predictor_lib.init_params(torch.Generator().manual_seed(1), cfg.predictor,
                                      cfg.talker.hidden_size, torch.float32, "cpu"))


def _randn(seed_or_rs, *shape) -> np.ndarray:
    """``RandomState(seed).randn(*shape) * 0.1`` in float32, as the JAX
    checks make their inputs (``jnp.asarray(randn, float32) * 0.1``)."""
    rs = (np.random.RandomState(seed_or_rs) if isinstance(seed_or_rs, int) else seed_or_rs)
    return rs.randn(*shape).astype(np.float32) * np.float32(0.1)


def _greedy():
    return GenerationPolicy(do_sample=False), predictor_lib.SamplingPolicy(do_sample=False)


def _ranks_agree(ids: np.ndarray, what: str) -> None:
    """Every rank of the world holds the same tokens (each sampled from the
    same all-gathered logits; dp replicas run the same request)."""
    got: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(got, ids)
    for r, other in enumerate(got):
        if not np.array_equal(other, ids):
            raise AssertionError(f"{what}: rank {r}'s tokens differ from rank "
                                 f"{dist.get_rank()}'s")


def _flash_launches() -> Dict[str, int]:
    fd = flash_lib.flash_decode
    return {"flash_decode": fd.launches, "flash_decode_int8kv": fd.launches_int8kv}


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def _eager_step_counts(eng: Engine, embeds, tth, tpe) -> Dict[str, Any]:
    """The collectives and flash-decode launches of one eager frame step
    (``decode_step``, never a captured replay) after a prefill of
    ``embeds``."""
    pol, ppol = _greedy()
    state = eng.prefill(embeds, None, pol, ppol)
    tth_d, tpe_d = upload(tth, eng.device, eng.dtype), upload(tpe, eng.device, eng.dtype)
    c0, f0 = collectives.counts(), _flash_launches()
    eng.decode_step(state, tth_d, tth_d.shape[1], tpe_d)
    c1, f1 = collectives.counts(), _flash_launches()
    eng.release(state)
    return {"eager_step_collectives": _delta(c1, c0),
            "eager_step_flash_decode": _delta(f1, f0)}


def _generate(cfg, params, mesh: Mesh, shard: bool, embeds, tth, tpe, steps: int,
              device_chunk: int, max_seq_len: int, kv_quant: bool, stats: Optional[Dict],
              **engine_kw) -> np.ndarray:
    """Greedy ``fast_generate`` through an Engine, sharded over ``mesh`` or
    whole.  With ``stats``: on an eager engine the first request's
    flash-decode launches (a captured replay launches without the counters,
    so a captured engine records none); then a second request (warm: its
    chunks replay what the first captured), which must give the same
    tokens, and its timing; and the counts of one eager step."""
    tpp, ppp = _params(cfg, params, mesh, shard)
    # the predictor's eager chain in both runs: the micro-step kernel runs no
    # mesh, and the whole run is held to the sharded one on the same path
    eng = Engine(tpp, ppp, cfg, max_seq_len=max_seq_len, kv_quant=kv_quant,
                 mesh=mesh if shard else None, use_micro_kernel=False, **engine_kw)
    pol, ppol = _greedy()

    def request():
        return loops.fast_generate(eng, embeds, tth, tpe, generator=None, max_new_tokens=steps,
                                   policy=pol, pred_policy=ppol, device_chunk=device_chunk)

    f0 = _flash_launches()
    ids, _ = request()
    if stats is not None:
        if eng.graphs is None:
            stats["flash_decode_launches"] = _delta(_flash_launches(), f0)
        again, timing = request()
        if not np.array_equal(again, ids):
            raise AssertionError("a second greedy request gave other tokens")
        stats.update(ms_per_step=timing["ms_per_step"], steps=timing["steps"],
                     prefill_ms=timing["prefill_ms"],
                     **_eager_step_counts(eng, embeds, tth, tpe))
    return np.asarray(ids)


def sharded_inference_check(
    mesh: Mesh, steps: int = 8, kv_quant: bool = False, *, params=None,
    use_flash_decode: Optional[bool] = None, use_cuda_graphs: Optional[bool] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The Engine's serving path (prefill + decode chunks of 4) with TP-
    sharded parameters and KV cache over ``mesh``, and the same on whole
    parameters; returns both greedy token sequences [steps, 16] (the
    unsharded one on global rank 0, else None).  ``params``: (talker,
    predictor) of the tiny shardable config, numpy or torch (default: the
    port's own seeded initialisers)."""
    cfg = _shardable_cfg()
    params = _tiny_params(cfg, params)
    H = cfg.talker.hidden_size
    embeds, tth = _randn(2, 1, 10, H), _randn(3, 1, 4, H)
    tpe = np.zeros((1, 1, H), np.float32)
    kw = dict(use_flash_decode=use_flash_decode, use_cuda_graphs=use_cuda_graphs)
    sharded = _generate(cfg, params, mesh, True, embeds, tth, tpe, steps, 4, 64, kv_quant,
                        None, **kw)
    _ranks_agree(sharded, "sharded_inference_check")
    single = (_generate(cfg, params, mesh, False, embeds, tth, tpe, steps, 4, 64, kv_quant,
                        None, **kw) if dist.get_rank() == 0 else None)
    return sharded, single


def sharded_batched_serving_check(
    mesh: Mesh, rows: int = 3, kv_quant: bool = False, *, params=None,
    use_flash_decode: Optional[bool] = None, use_cuda_graphs: Optional[bool] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """TP-shard the batched serving path, the continuous batcher's sequence
    of calls: a ``rows``-row prefill, three decode chunks of 8, a mid-batch
    ``join_row`` into the sharded cache at ``pos_hint=34``, one more chunk.
    Returns (sharded, unsharded on global rank 0 or None) greedy tokens
    [rows, 32, 16].  The join's writes land on the batch and slot axes, so
    the cache split by kv head takes them as they are."""
    cfg = _shardable_cfg()
    params = _tiny_params(cfg, params)
    H = cfg.talker.hidden_size
    rs = np.random.RandomState(5)
    embeds, joiner, tth = _randn(rs, rows, 10, H), _randn(rs, 1, 9, H), _randn(rs, rows, 4, H)
    tpe = np.zeros((rows, 1, H), np.float32)
    pol = GenerationPolicy(do_sample=False, min_new_tokens=1000)
    ppol = predictor_lib.SamplingPolicy(do_sample=False)

    def run(shard: bool) -> np.ndarray:
        tpp, ppp = _params(cfg, params, mesh, shard)
        eng = Engine(tpp, ppp, cfg, max_seq_len=64, batch=rows, kv_quant=kv_quant,
                     mesh=mesh if shard else None, use_flash_decode=use_flash_decode,
                     use_cuda_graphs=use_cuda_graphs)
        tth_d, tpe_d = upload(tth, eng.device, eng.dtype), upload(tpe, eng.device, eng.dtype)
        state = eng.prefill(embeds, None, pol, ppol)
        chunks = []
        for join in (False, False, False, True):  # 24 steps: pos passes the joiner's bucket
            if join:
                state = eng.join_row(state, rows - 1, joiner, policy=pol, pred_policy=ppol,
                                     pos_hint=34)
            state, frames, n, lens, done = eng.decode_chunk(state, tth_d, 0, tpe_d, 8)
            chunks.append(frames.cpu().numpy())
        eng.release(state)
        return np.concatenate(chunks, axis=1)  # [rows, 32, 16]

    sharded = run(True)
    _ranks_agree(sharded, "sharded_batched_serving_check")
    return sharded, run(False) if dist.get_rank() == 0 else None


def host_init_flagship(cfg: TTSModelConfig, dtype: torch.dtype = torch.float32
                       ) -> Tuple[Dict, Dict]:
    """(talker, predictor) parameters for ``cfg`` drawn on the host from
    numpy, as the JAX package's ``_host_init_tree`` draws them
    (``sharding.py:269-310``), leaf for leaf the same bits: a generator
    ``np.random.default_rng(seed)`` (0 the talker's, 1 the predictor's)
    visits the leaves in JAX's flattening order (dict keys sorted, depth
    first); a leaf whose path holds "norm" is ones, any other 1-D leaf
    zeros, a matrix ``N(0, 1) * fan_in ** -0.5`` in float32 with ``fan_in =
    shape[-2]``, then cast to ``dtype``.  CPU tensors."""
    meta, f32 = torch.device("meta"), torch.float32
    tk = cfg.talker
    t_shapes = talker_lib.init_params(None, tk, f32, meta)
    p_shapes = predictor_lib.init_params(None, cfg.predictor, tk.hidden_size, f32, meta)
    return _host_init_tree(t_shapes, 0, dtype), _host_init_tree(p_shapes, 1, dtype)


def _host_init_tree(shape_tree: Dict, seed: int, dtype: torch.dtype) -> Dict:
    rng = np.random.default_rng(seed)

    def make(path: str, shape: Tuple[int, ...]) -> torch.Tensor:
        if "norm" in path:
            return torch.ones(shape, dtype=dtype)
        if len(shape) == 1:
            return torch.zeros(shape, dtype=dtype)
        x = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(x * shape[-2] ** -0.5).to(dtype)

    def walk(tree: Dict, prefix: str) -> Dict:
        out = {}
        for k in sorted(tree):
            path = f"{prefix}/{k}" if prefix else k
            v = tree[k]
            out[k] = walk(v, path) if isinstance(v, dict) else make(path, tuple(v.shape))
        return out

    return walk(shape_tree, "")


def _preset(preset) -> TTSModelConfig:
    return preset if isinstance(preset, TTSModelConfig) else get_preset(preset)


def sharded_flagship_check(
    mesh: Mesh,
    steps: int = 4,
    *,
    preset="qwen3-tts-0.6b",
    kv_quant: bool = True,
    max_seq_len: int = 64,
    dtype: Optional[str] = "float32",
    params: Optional[Tuple[Dict, Dict]] = None,
    run_single: bool = True,
    use_flash_decode: Optional[bool] = None,
    use_cuda_graphs: Optional[bool] = None,
    stats: Optional[Dict] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A preset's full geometry (``preset``: a name or a TTSModelConfig; the
    0.6B: 28 layers, hidden 1024, GQA 16/8) through the Engine's serving
    path under TP, with the int8 KV cache by default (its scale planes split
    by kv head beside it).  Greedy tokens of the sharded run, and of the
    whole run on global rank 0 (``run_single``), else None.

    ``dtype`` defaults to float32 for the parity claim: in bf16 the
    row-parallel sum's other order may flip a near-tied argmax after a few
    28-layer steps (the JAX check's lesson), which
    ``sharded_flagship_structural_check`` bounds instead.  ``params``: float
    (talker, predictor) trees to reuse, cast to ``dtype`` (default
    ``host_init_flagship``).  ``stats``, when given, takes for each run
    (``"sharded"``, ``"single"``) the first request's flash-decode launches
    (eager engines only), a second, warm request's ``fast_generate``
    ms/step and prefill ms, and the collectives and flash-decode launches
    of one more step, run eagerly even on a captured engine."""
    cfg = _preset(preset)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    tk = cfg.talker
    tp = mesh.shape["tp"]
    if tk.num_key_value_heads % tp:
        raise ValueError(f"{tk.num_key_value_heads} kv heads do not split {tp} ways")
    tdtype = cfg.torch_dtype
    if params is None:
        params = host_init_flagship(cfg, torch.float32)
    params = (_host(params[0], tdtype), _host(params[1], tdtype))
    H = tk.hidden_size
    embeds, tth = _randn(2, 1, 10, H), _randn(3, 1, 4, H)
    tpe = np.zeros((1, 1, H), np.float32)
    kw = dict(use_flash_decode=use_flash_decode, use_cuda_graphs=use_cuda_graphs)
    run_stats = {"sharded": {}, "single": {}} if stats is not None else None
    sharded = _generate(cfg, params, mesh, True, embeds, tth, tpe, steps, min(4, steps),
                        max_seq_len, kv_quant, run_stats and run_stats["sharded"], **kw)
    _ranks_agree(sharded, "sharded_flagship_check")
    single = None
    if run_single and dist.get_rank() == 0:
        single = _generate(cfg, params, mesh, False, embeds, tth, tpe, steps, min(4, steps),
                           max_seq_len, kv_quant, run_stats and run_stats["single"], **kw)
    if stats is not None:
        stats.update(run_stats)
    return sharded, single


def _prompt_logits(cfg: TTSModelConfig, tparams32: Dict, embeds32: np.ndarray, mesh: Mesh,
                   dtype: torch.dtype, shard: bool) -> np.ndarray:
    """Codec-head logits [T, V] (float32) of every prompt position: the
    talker's stack over a fresh cache, as ``talker.prefill`` runs it."""
    tk = cfg.talker
    p = _host(tparams32, dtype)
    if shard:
        p, group, tp = (shard_params(p, mesh, talker_param_specs(tk)), mesh.tp_group,
                        mesh.shape["tp"])
    else:
        p, group, tp = _placed(p, mesh.device), None, 1
    dev = mesh.device
    with torch.inference_mode():
        e = torch.from_numpy(embeds32).to(dev, dtype)
        T = e.shape[1]
        pad = torch.zeros((1,), dtype=torch.int32, device=dev)
        kv = talker_lib.new_kv_cache(tk, 1, T, dtype, dev, tp=tp)
        cos, sin = talker_lib._positions(tk, torch.arange(T, device=dev)[None, :])
        x, _ = stack_forward(p["blocks"], e, cos, sin, kv, 0, prefill_mask(T, T, pad),
                             talker_lib.block_spec(tk, tp), group=group)
        x = rms_norm(x, p["final_norm"], tk.rms_norm_eps)
        return talker_lib.codec_head(p, x, group)[0].cpu().numpy()


def sharded_flagship_structural_check(
    mesh: Mesh,
    steps: int = 6,
    *,
    preset="qwen3-tts-0.6b",
    kv_quant: bool = True,
    max_seq_len: int = 64,
    params: Optional[Tuple[Dict, Dict]] = None,
    fp32_ids: Optional[np.ndarray] = None,
    engine_generation: bool = True,
    use_flash_decode: Optional[bool] = None,
    use_cuda_graphs: Optional[bool] = None,
) -> Dict[str, float]:
    """bf16 flagship TP, the production dtype (where token equality is the
    wrong claim): on global rank 0 it asserts, as the JAX check does,

    * the bf16 TP-sharded prompt logits stay within bf16 accumulation noise
      of the whole float32 run: max |delta| < 0.08 * the logit scale and
      argmax agreement >= 0.8;
    * with ``engine_generation``, a bf16 TP-sharded generation through the
      Engine gives structurally valid frames: ids in range, the suppressed
      zone never sampled, no EOS in an emitted frame.

    Returns the deltas and the token agreement with ``fp32_ids`` (the
    float32 whole run's tokens from ``sharded_flagship_check``; without
    them a bf16 whole run on rank 0) on rank 0; the other ranks return
    ``{}``.  ``params``: float32 trees to reuse (default
    ``host_init_flagship``)."""
    cfg = _preset(preset)
    tk = cfg.talker
    if params is None:
        params = host_init_flagship(cfg, torch.float32)
    H = tk.hidden_size
    embeds32 = _randn(2, 1, 10, H)
    lobf = _prompt_logits(cfg, params[0], embeds32, mesh, torch.bfloat16, shard=True)
    out: Dict[str, float] = {}
    if dist.get_rank() == 0:
        lo32 = _prompt_logits(cfg, params[0], embeds32, mesh, torch.float32, shard=False)
        scale = max(1.0, float(np.abs(lo32).max()))
        max_delta = float(np.abs(lo32 - lobf).max())
        argmax_agree = float((lo32.argmax(-1) == lobf.argmax(-1)).mean())
        if not max_delta < 0.08 * scale:
            raise AssertionError(f"bf16 TP logits moved beyond accumulation noise: max|delta| "
                                 f"{max_delta:.4f} vs scale {scale:.2f}")
        if not argmax_agree >= 0.8:
            raise AssertionError(f"bf16 TP argmax agreement {argmax_agree:.2f} < 0.8")
        out = {"logit_max_delta": max_delta, "logit_scale": scale,
               "argmax_agree": argmax_agree,
               "bf16_token_agree_vs_replicated": float("nan"), "steps": 0}
    if not engine_generation:
        return out
    ids, ids_single = sharded_flagship_check(
        mesh, steps=steps, preset=cfg, kv_quant=kv_quant, max_seq_len=max_seq_len,
        dtype="bfloat16", params=params, run_single=fp32_ids is None,
        use_flash_decode=use_flash_decode, use_cuda_graphs=use_cuda_graphs)
    if dist.get_rank() != 0:
        return out
    if ids_single is None:
        ids_single = fp32_ids
    if not (ids.ndim == 2 and ids.shape[1] == 16 and ids.shape[0] >= 1):
        raise AssertionError(f"bf16 TP frames of shape {ids.shape}")
    if not ((ids >= 0).all() and (ids[:, 1:] < cfg.predictor.codebook_size).all()):
        raise AssertionError("bf16 TP frames hold an id out of range")
    if not (ids[:, 0] < tk.vocab_size - 1024).all():
        raise AssertionError("bf16 TP sampled the suppressed zone")
    if (ids[:, 0] == tk.codec_eos_token_id).any():
        raise AssertionError("bf16 TP emitted an EOS inside a frame")
    n = min(len(ids), len(ids_single))
    out.update(bf16_token_agree_vs_replicated=float((ids[:n, 0] == ids_single[:n, 0]).mean()),
               steps=int(ids.shape[0]))
    return out


# ---------------------------------------------------------------------------
# sharded training step (forward + loss + grad + adamw)
# ---------------------------------------------------------------------------


def _talker_nll(params, cfg: TalkerConfig, embeds: torch.Tensor, targets: torch.Tensor,
                pad_count: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the masked NLL summed over the rows' valid positions, the count of
    those positions): ``_talker_loss`` before its division.  With a tp
    ``group`` the params are this rank's shard."""
    B, T, _ = embeds.shape
    dev = embeds.device
    tp = collectives.size(group)
    kv = talker_lib.new_kv_cache(cfg, B, T, embeds.dtype, dev, tp=tp)
    pad = pad_count.reshape(-1, 1).long()
    t = torch.arange(T, device=dev)[None, :]
    cos, sin = talker_lib._positions(cfg, (t - pad).clamp_min(0))
    x, _ = stack_forward(params["blocks"], embeds, cos, sin, kv, 0,
                         prefill_mask(T, T, pad_count), talker_lib.block_spec(cfg, tp),
                         group=group)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logp = torch.log_softmax(talker_lib.codec_head(params, x, group), dim=-1)  # [B, T, V]
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    valid = (t >= pad).float()
    return (nll * valid).sum(), valid.sum()


def _talker_loss(params, cfg: TalkerConfig, embeds: torch.Tensor, targets: torch.Tensor,
                 pad_count: torch.Tensor, group=None) -> torch.Tensor:
    """CE loss of codec-head logits against next-frame codebook-0 targets
    [B, T], averaged over the positions at or after each row's left pad: a
    fresh KV cache, pad-corrected positions, ``prefill_mask``, the stack,
    ``final_norm``, the codec head, ``log_softmax``."""
    nll, n = _talker_nll(params, cfg, embeds, targets, pad_count, group)
    return nll / n.clamp_min(1.0)


# leaves whole on every rank whose gradient is a rank's partial sum: the
# per-head q / k norms, applied to the rank's own heads only
_TP_PARTIAL_GRADS = ("blocks/q_norm", "blocks/k_norm")


def _on(x, device, dtype=None) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
    return x.to(device, dtype) if dtype is not None else x.to(device)


def make_train_step(cfg: TalkerConfig, mesh: Optional[Mesh] = None,
                    learning_rate: float = 1e-4, *, device=None):
    """``(init_opt, train_step)``: ``optax.adamw(learning_rate)`` over the
    talker loss, each rank on its shard of the parameters
    (``shard_params(..., talker_param_specs(cfg))``; every rank of the mesh
    calls ``train_step``).  ``mesh=None`` is one process, unsharded, on
    ``device`` (default: the card; with no card it raises, and the CPU must
    be asked for: ``device="cpu"``); with a mesh, on ``mesh.device``.

    ``train_step(params, opt_state, embeds [B, T, H], targets [B, T],
    pad_count [B])`` -> ``(params, opt_state, loss)``: every rank passes
    the global batch (numpy or tensors) and takes its dp rows; the loss is
    the masked mean over the whole batch (the NLL sum and the valid count
    all-reduced over dp, not a mean of the ranks' means); the gradients
    are summed over dp, and those of ``q_norm`` / ``k_norm`` over tp.
    ``params`` and ``opt_state`` are updated in place (JAX donates them)
    and returned; ``loss`` is a 0-d tensor.  Parameters made under
    ``torch.inference_mode()`` cannot take gradients: build them outside
    it.

    Collectives a step at tp > 1 (``collectives.counts`` /
    ``backward_counts``): forward 2 L all-reduces and 1 all-gather (the
    codec head), backward 2 L + 1 all-reduces (``copy_to_tp`` before qkv,
    gate|up and the codec head) and 1 for the q / k norms; at dp > 1 one
    more forward (the loss's sum and count) and one more backward (the
    gradients, one flat buffer)."""
    refuse_hybrid(cfg)
    if mesh is None:
        device = _resolved(device)
        dp, dp_rank, tp_group, dp_group = 1, 0, None, None
    else:
        if device is not None and _resolved(device) != mesh.device:
            raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
        device, dp, dp_rank = mesh.device, mesh.shape["dp"], mesh.dp_rank
        tp_group = mesh.tp_group if mesh.shape["tp"] > 1 else None
        dp_group = mesh.dp_group if dp > 1 else None
    opt = optim.adamw(learning_rate)

    def init_opt(params):
        return opt.init(params)

    def train_step(params, opt_state, embeds, targets, pad_count):
        named = optim.named_leaves(params)
        dtype = named[0][1].dtype
        embeds = _on(embeds, device, dtype)
        targets, pad_count = _on(targets, device), _on(pad_count, device, torch.int32)
        B = embeds.shape[0]
        if B % dp:
            raise ValueError(f"a batch of {B} rows does not split over dp {dp}")
        rows = slice(dp_rank * (B // dp), (dp_rank + 1) * (B // dp))
        ps = [p for _, p in named]
        for path, p in named:
            if p.device != device:
                raise ValueError(f"{path} is on {p.device}, the step runs on {device}")
            if p.is_inference():
                raise ValueError(f"{path} was made under torch.inference_mode() and cannot "
                                 "take a gradient: build training parameters outside it")
        try:
            for p in ps:
                p.requires_grad_(True)
            nll, n = _talker_nll(params, cfg, embeds[rows], targets[rows], pad_count[rows],
                                 tp_group)
            totals = torch.stack([nll.detach(), n])
            if dp_group is not None:
                collectives.all_reduce(totals, dp_group)
            denom = totals[1].clamp_min(1.0)
            grads = list(torch.autograd.grad(nll / denom, ps, allow_unused=True))
        finally:
            for p in ps:
                p.requires_grad_(False)
        if tp_group is not None:
            collectives.all_reduce_grads(
                [g for (path, _), g in zip(named, grads) if path in _TP_PARTIAL_GRADS],
                tp_group)
        if dp_group is not None:
            collectives.all_reduce_grads([g for g in grads if g is not None], dp_group)
        opt.step(params, grads, opt_state)
        return params, opt_state, totals[0] / denom

    return init_opt, train_step
