"""Decode runtime: the left-padded prefill, the fused frame step, chunks that
stop when every row is done, the chunk + streaming-vocode pairing, and
continuous batching (``join_row``), at batch 1 or ``batch`` rows.

Port of ``qwen3tts_tpu/runtime/engine.py``.  Where the JAX engine compiles a
chunk of steps into one program (``jax.jit`` of ``_chunk_impl`` and of the
decode + vocode composite), this one captures it into one CUDA graph
(``runtime/graphs.py``) on the card, keyed as the JAX programs are: chunk
size, trailing-text length, the policies' structure (``StaticPolicy``), with
or without the vocoder (one row's or every row's), and, since a graph reads
fixed addresses, the KV cache it was captured on.  ``decode_chunk``,
``chunk_vocode`` and ``chunk_vocode_batched`` replay the graph for their
key, capturing it first when there is none, as JAX compiles on a new static
argument.  On CPU tensors (and with ``use_cuda_graphs=False``) the same
steps run eagerly.  The eager chunks on the card are the cache's last,
which the host caps below the chunk size, and every chunk run inside
``Engine.eager()`` (a traced generation: the profiler is never active
around a graph replay).

A chunk stops as the JAX ``while_loop`` does: a step runs only while some
row is live and the position is below ``max_seq_len - 1``.  The eager chunk
reads ``done`` after each step; a captured chunk wraps each step in a CUDA
graph conditional node whose predicate the graph computes before the step.
A chunk returns ``n``, the steps it ran (a device scalar), and its frames
past ``n`` are zeros.

The numeric sampling knobs are one float32 device tensor made per
generation (``make_knobs``), so a request with another temperature replays
the same graph.  The decode step updates its state in place: a replayed
graph keeps reading and writing the tensors it captured.  All per-step state
(position, counters, seen mask, done flags) lives in device tensors, and the
cache is written at the device-side position, so a chunk runs without any
host sync; the host reads results once per chunk.  The host tracks the
position itself (``pos_host``) to cap a chunk at ``max_seq_len - 1``: a
dispatched chunk adds the steps it may run, and ``settle`` takes back the
ones it did not, when the chunk's ``n`` is read.  The step's parts are named
ranges for ``torch.profiler``: ``predictor_frame``, ``talker_step`` and
``codec_stream``.

The prefill is eager, so it needs no buckets: the prompt [B, T, H] (each
row left-padded by its own ``pad_count``) is left-padded on the host only
as far as ``pos_floor`` asks (to ``Tb``, at most the JAX bucket
``bucket_for(T)``), and the cache is then rolled left along its position
axis by the pad that every row shares (at most ``Tb - pos_floor``), so that
``pos`` starts at ``Tb - roll``: the ``pos`` and ``pad_count`` of the JAX
prefill, which pads to the bucket and rolls that back.  The roll moves the
slots that are read, ``[roll, Tb)``, to ``[0, Tb - roll)``; every slot past
them is written by a step before any step reads it.  At batch 1 nothing is
padded: pad 0 and ``pos = T``.

Each request takes its own KV cache (``new_kv``) and hands it back when its
generation ends (``release``, as the JAX engine does).  The pool keeps one
cache, and besides it every cache that graphs were captured on, so that the
graphs are replayed again: a live request never shares its cache, and
requests that run one after another reuse one cache and its graphs.
``join_row`` admits one request into a row of a running batch: its prompt is
prefilled into a cache of its own bucket's length and spliced into the
batch's cache so that it ends at the shared position.

Options as in the JAX engine: ``batch`` (rows per step); ``use_flash_decode``
(default on; ``False`` runs the plain masked attention, for debugging);
``use_fused_kernels`` (default off) runs the talker's decode step and the
predictor's 14 micro-steps through the fused block kernels
(``ops/fused_block.py``); ``use_micro_kernel`` runs each predictor
micro-step as one launch of ``ops/predictor_step.py:fused_micro_step`` for
all the rows: by default (None) wherever its one gate,
``models/predictor.py:micro_kernel_misfit``, lets it (CUDA tensors, at most
16 rows, plain predictor blocks, no sliding window, no mesh), the eager
block chain elsewhere; True raises where the gate refuses; False always
runs the eager chain (the JAX engine's default, kept by profilers that time
the chain's products);
``kv_quant`` keeps the talker's KV cache in int8 with f32 per-(slot, head)
scales, read by the int8-KV flash-decode kernel.

A hybrid talker (``TalkerConfig.is_hybrid``: LFM2's short convolutions,
attention and routed experts, ``models/lfm2.py``) runs through the same
calls.  Its cache dict holds the attention layers' KV and, beside it, the
convolution state ``"conv"`` [Lc, B, H, 3]: per-row state, which the
prefill's roll leaves as it is and ``join_row`` copies whole into the row
(``talker.roll_cache`` / ``splice_row``); a captured chunk updates it in
place like the KV.  Its routed layers add their routing to
``route_stats`` (``ops/routed_experts.py:RouteStats``, held by ``TRACE``
as well).  It runs without a mesh, the fused block
kernels and an int8 KV cache: those raise (``talker.check_hybrid``).

``mesh`` (``parallel/sharding.py:Mesh``) runs the engine tensor-parallel:
the parameters are this rank's shard (``shard_params``), and the KV caches,
the predictor's frame scratch and the layer views are built at the
rank-local geometry (``BlockSpec.shard``), the caches split by kv head
(``kv_cache_specs``).  Every rank of the mesh runs the same calls; the
model's collectives go over ``mesh.tp_group``.  ``join_row``, the chunks,
``prefill`` and ``release`` need nothing else: their writes land on the
batch and slot axes, never on kv heads.  With a mesh the fused kernels,
an asked-for micro-step kernel and quantized weights raise (each runs, inside one
kernel or one product, what the row-parallel all-reduce must split), and
so do captured chunks on a gloo group, which CUDA graphs cannot hold, and
on NCCL unless ``NCCL_GRAPH_MIXING_SUPPORT=0`` was set before the group
started (``launch`` sets it): with it NCCL captures kernel and memcpy nodes
only, which fit in each step's conditional node.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..core.config import TTSModelConfig
from ..models import codec as codec_lib
from ..models import lfm2
from ..models import predictor as predictor_lib
from ..models import talker as talker_lib
from ..models.layers import unstack_layers
from ..models.predictor import SamplingPolicy
from ..ops.predictor_step import micro_step_weights
from ..ops.quant import is_quantized
from ..ops.routed_experts import RouteStats
from ..utils.timing import TRACE
from ..ops.sampling import apply_repetition_penalty, build_suppress_mask, sample_logits

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
# Trailing-text buckets: the loops pad the trailing text to one of these, so
# a few captured chunks serve every text length.
TTH_BUCKETS = (16, 64, 256, 1024, 2048)


def bucket_for(n: int, buckets=PREFILL_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"Input is too long: prefill has {n} tokens but max bucket={buckets[-1]}. "
        "Use shorter text or shorter reference audio."
    )


@dataclasses.dataclass(frozen=True)
class StaticPolicy:
    """The structural part of a sampling policy: what a captured chunk is
    keyed on.  The numbers (temperature, top_p, penalty, min_new_tokens)
    are device knobs (``make_knobs``), so changing them captures nothing."""

    do_sample: bool = True
    top_k: int = 50
    use_top_p: bool = False
    use_rep_penalty: bool = True


@dataclasses.dataclass(frozen=True)
class GenerationPolicy:
    """Sampling policy for the talker's codebook-0 head."""

    temperature: float = 0.9
    top_k: int = 50
    top_p: float = 1.0
    do_sample: bool = True
    repetition_penalty: float = 1.05
    min_new_tokens: int = 2

    @property
    def static(self) -> StaticPolicy:
        return StaticPolicy(do_sample=self.do_sample, top_k=self.top_k,
                            use_top_p=self.top_p < 1.0,
                            use_rep_penalty=self.repetition_penalty != 1.0)


def make_knobs(policy: GenerationPolicy, pred_policy: SamplingPolicy,
               device) -> torch.Tensor:
    """The numeric knobs as one float32 [6] tensor on ``device``, made once
    per generation: [temperature, top_p, repetition_penalty, min_new_tokens,
    predictor temperature, predictor top_p].  The copy to the card is
    asynchronous (from pinned memory)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    host = torch.tensor([policy.temperature, policy.top_p, policy.repetition_penalty,
                         float(policy.min_new_tokens), pred_policy.temperature,
                         pred_policy.top_p], dtype=torch.float32)
    if cuda:
        host = host.pin_memory()
    return host.to(device, non_blocking=cuda)


def upload(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A host array or tensor on ``device`` in ``dtype``: to the card
    asynchronously, from pinned memory."""
    t = torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(device, dtype)


def _check_mesh(mesh, talker_params, predictor_params, fused: bool, micro: bool,
                graphs: bool) -> None:
    """Raise for what a tensor-parallel engine cannot run."""
    if fused or micro:
        raise ValueError("use_fused_kernels / use_micro_kernel with a mesh: fused_o_mlp adds "
                         "the residual inside the kernel, before the row-parallel all-reduce "
                         "can run, and the micro-step kernel runs the whole predictor")
    leaves = (talker_params["blocks"]["qkv_proj"], predictor_params["blocks"]["qkv_proj"],
              predictor_params["lm_heads"])
    if any(is_quantized(leaf) for leaf in leaves):
        raise ValueError("quantized weights with a mesh: shard_params splits float leaves only")
    if graphs and mesh.backend == "gloo":
        raise ValueError("use_cuda_graphs with a gloo mesh: gloo's collectives run on the "
                         "host and cannot be captured; pass use_cuda_graphs=False")
    if graphs and os.environ.get("NCCL_GRAPH_MIXING_SUPPORT") != "0":
        raise ValueError("use_cuda_graphs with an NCCL mesh needs NCCL_GRAPH_MIXING_SUPPORT=0 "
                         "set before the process group starts (parallel/sharding.py:launch "
                         "sets it): NCCL's graph-mixing support records events into a captured "
                         "step, and a conditional node's body takes none")


# the decode state's tensors: what a captured chunk reads and writes in place
STATE_TENSORS = ("past_hidden", "token", "pos", "pad_count", "gen_step", "seen", "n_gen",
                 "done", "knobs")


class Engine:
    """Runtime for one (talker, predictor) model instance at ``batch`` rows."""

    def __init__(
        self,
        talker_params,
        predictor_params,
        cfg: TTSModelConfig,
        *,
        max_seq_len: int = 2048,
        batch: int = 1,
        use_flash_decode: Optional[bool] = None,
        use_fused_kernels: Optional[bool] = None,
        use_micro_kernel: Optional[bool] = None,
        use_cuda_graphs: Optional[bool] = None,
        kv_quant: bool = False,
        mesh=None,
    ):
        self.cfg = cfg
        self.talker_cfg = cfg.talker
        self.pred_cfg = cfg.predictor
        self.talker_params = talker_params
        self.predictor_params = predictor_params
        self.max_seq_len = max_seq_len
        if batch < 1:
            raise ValueError(f"batch must be at least 1, got {batch}")
        self.batch = batch
        emb = talker_params["codec_embedding"]
        self.device = emb.device
        self.dtype = emb.dtype
        self.eos_id = cfg.talker.codec_eos_token_id
        tc = cfg.talker
        # the flash wrapper takes its plain version on CPU tensors; on the
        # card it launches the kernel, or raises for a head layout it lacks
        self.use_flash_decode = use_flash_decode is not False
        # off unless asked for, as in the JAX engine (engine.py:142-153)
        self.use_fused_kernels = bool(use_fused_kernels)
        if use_cuda_graphs is None:
            use_cuda_graphs = self.device.type == "cuda"
        self.group = None if mesh is None else mesh.tp_group
        self.tp = 1 if mesh is None else mesh.shape["tp"]
        if tc.is_hybrid:
            talker_lib.check_hybrid(tc, kv_quant=kv_quant, group=self.group,
                                    fused=self.use_fused_kernels)
        if mesh is not None:
            _check_mesh(mesh, talker_params, predictor_params, self.use_fused_kernels,
                        bool(use_micro_kernel), use_cuda_graphs)
        misfit = predictor_lib.micro_kernel_misfit(predictor_params, cfg.predictor, batch,
                                                   self.device, self.group)
        if use_micro_kernel and misfit:
            raise ValueError(f"use_micro_kernel=True: {misfit}")
        self.use_micro_kernel = misfit is None and use_micro_kernel is not False
        # which path each dispatched frame step takes (TRACE's counters)
        self._frames_counter = ("predictor_frames.kernel" if self.use_micro_kernel
                                else "predictor_frames.eager")
        self._micro_weights = (micro_step_weights(predictor_params) if self.use_micro_kernel
                               else None)
        self.kv_quant = kv_quant
        # a hybrid talker's routed layers count their routing on the device
        self.route_stats = (RouteStats(lfm2.counts(tc)["moe"], tc.num_experts, batch,
                                       self.device) if tc.is_hybrid else None)
        if self.route_stats is not None:
            TRACE.add_routes(self.route_stats)
        self._talker_layers = talker_lib.layer_views(talker_params, tc, self.route_stats)
        self._pred_layers = unstack_layers(predictor_params["blocks"])
        self._frame_scratch = predictor_lib.frame_scratch(cfg.predictor, self.batch,
                                                          self.dtype, self.device, self.tp)
        self._suppress = torch.from_numpy(
            build_suppress_mask(tc.vocab_size, self.eos_id)).to(self.device)
        self.graphs = None
        if use_cuda_graphs:
            from .graphs import ChunkGraphs

            self.graphs = ChunkGraphs(self)
        # finished generations' caches, handed to the next prefill (stale
        # rows are never read: every read is bounded to the live prefix)
        self._kv_pool = []
        self._kv_lock = threading.Lock()
        self.warmed_up = False
        self._eager_depth = 0  # > 0 inside eager(): no chunk is replayed
        self._stamps = None  # a recording capture's stamp buffer while it captures

    @contextlib.contextmanager
    def eager(self):
        """Run every chunk of this engine eagerly inside the block, never
        through ``ChunkGraphs.run``: the profiler's tracing lost kernel
        records of replayed graphs and a later replay faulted on the H100
        (``utils/timing.py:device_trace``), so a traced generation runs
        here.  Graphs captured before the block stay for later requests."""
        self._eager_depth += 1
        try:
            yield self
        finally:
            self._eager_depth -= 1

    @contextlib.contextmanager
    def _part(self, name: str):
        """The step part ``name``: a ``record_function`` range and, while a
        recording ``ChunkGraphs`` captures, a device timestamp at each end
        that its layout keeps (``runtime/graphs.py:_Stamps``)."""
        stamps = self._stamps
        with record_function(name):
            if stamps is not None:
                stamps.mark(name, 0)
            yield
            if stamps is not None:
                stamps.mark(name, 1)

    def _has_graphs(self, kv) -> bool:
        return self.graphs is not None and self.graphs.has_graphs(kv)

    def new_kv(self) -> Dict[str, torch.Tensor]:
        """A KV cache [L, B, S, KVH, D] (int8 plus scales with ``kv_quant``)
        that no live request holds: a pooled one (one with captured graphs
        first), or a new one."""
        with self._kv_lock:
            if self._kv_pool:
                i = next((i for i, kv in enumerate(self._kv_pool) if self._has_graphs(kv)),
                         len(self._kv_pool) - 1)
                return self._kv_pool.pop(i)
        return talker_lib.new_kv_cache(
            self.talker_cfg, self.batch, self.max_seq_len, self.dtype, self.device,
            kv_quant=self.kv_quant, tp=self.tp)

    def release(self, state: Dict) -> None:
        """Recycle a finished generation's KV cache: into an empty pool, and
        always when graphs were captured on it."""
        with self._kv_lock:
            if not state or "kv" not in state:
                return
            kv = state["kv"]
            if any(k is kv for k in self._kv_pool):
                return
            if not self._kv_pool or self._has_graphs(kv):
                self._kv_pool.append(kv)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, embeds, generator: Optional[torch.Generator],
                policy: GenerationPolicy, pred_policy: SamplingPolicy = SamplingPolicy(),
                pad_count=None, pos_floor: Optional[int] = None) -> Dict:
        """Run the prompt [B, T, H] (numpy or tensor; rows already
        left-padded by ``pad_count`` [B]) into the cache, roll the pad that
        every row shares out of the cache and sample the first token.
        Returns the decode state.  ``pos_floor`` keeps ``pos`` at least
        there, up to the prompt's bucket (a row that joins later splices its
        bucket in below ``pos``): the prompt is left-padded to it.  ``pos``
        and ``pad_count`` are those of the JAX engine's prefill, which pads
        to ``bucket_for(T)`` (bounding its compiles) and rolls back what it
        can; this one is eager and pads no further.  Eager on every device."""
        B, T, H = embeds.shape
        if B != self.batch:
            raise ValueError(f"engine batch {self.batch} got prompt batch {B}")
        bucket = bucket_for(T)
        if bucket > self.max_seq_len:
            raise ValueError(f"prefill bucket {bucket} exceeds max_seq_len {self.max_seq_len}")
        Tb = max(T, min(pos_floor or 0, bucket))
        extra = Tb - T
        embeds = upload(embeds, self.device, self.dtype)
        if extra:
            embeds = torch.cat([embeds.new_zeros((B, extra, H)), embeds], dim=1)
        pads = (np.zeros((B,), np.int64) if pad_count is None
                else np.asarray(pad_count, np.int64).reshape(B)) + extra
        max_roll = Tb if pos_floor is None else max(Tb - pos_floor, 0)
        roll = min(int(pads.min()), max_roll)
        dev = self.device
        pad = upload(pads, dev, torch.int32)
        last, logits, kv = talker_lib.prefill(
            self.talker_params, self.talker_cfg, embeds, pad, self.new_kv(),
            layers=self._talker_layers, group=self.group)
        if roll:
            talker_lib.roll_cache(kv, roll, Tb)
            pad = pad - roll
        knobs = make_knobs(policy, pred_policy, dev)
        st = policy.static
        token = sample_logits(
            generator, logits, temperature=knobs[0], top_k=st.top_k, top_p=knobs[1],
            use_top_p=st.use_top_p, do_sample=st.do_sample, suppress_mask=self._suppress,
            suppress_eos=knobs[3] > 0, eos_id=self.eos_id)
        return {
            "kv": kv,
            "past_hidden": last,
            "token": token,
            "pos": torch.full((1,), Tb - roll, dtype=torch.int32, device=dev),
            "pos_host": Tb - roll,
            "planned": deque(),
            "pad_count": pad,
            "gen_step": torch.zeros((B,), dtype=torch.int64, device=dev),
            "seen": torch.zeros((B, self.talker_cfg.vocab_size), dtype=torch.bool,
                                device=dev),
            "n_gen": torch.zeros((B,), dtype=torch.int64, device=dev),
            "done": token == self.eos_id,
            "knobs": knobs,
            "generator": generator,
            "policy": policy,
            "pred_policy": pred_policy,
        }

    # ------------------------------------------------------------------
    def _one_step(self, state: Dict, tth: torch.Tensor, tth_len, tpe: torch.Tensor
                  ) -> torch.Tensor:
        """One frame step, updating the state's tensors in place: predictor
        frame, talker decode step, repetition penalty, sampling.  Returns the
        frame [B, 16] (input token + 15 predictor codebooks).  ``tth_len``
        is an int or a device tensor.  No host sync."""
        tcfg = self.talker_cfg
        policy: StaticPolicy = state["policy"].static
        knobs = state["knobs"]
        gen = state["generator"]
        token = state["token"]
        B = token.shape[0]

        tok_embed = talker_lib.embed_codec(self.talker_params, token, self.group)[:, None, :]
        pred_input = torch.cat([state["past_hidden"], tok_embed], dim=1)
        with self._part("predictor_frame"):
            cb_tokens, cb_embed_sum = predictor_lib.predict_frame(
                self.predictor_params, self.pred_cfg, pred_input, gen,
                state["pred_policy"].static, layers=self._pred_layers,
                fused=self.use_fused_kernels, micro_kernel=self.use_micro_kernel,
                micro_weights=self._micro_weights, temperature=knobs[4], top_p=knobs[5],
                scratch=self._frame_scratch, group=self.group)
        frame = torch.cat([token[:, None], cb_tokens], dim=1)  # [B, 16]

        # next talker input = sum of the 16 codec embeds + trailing text hidden
        x = tok_embed + cb_embed_sum.to(tok_embed.dtype)
        gs = state["gen_step"]
        idx = gs.clamp_max(tth.shape[1] - 1)
        row_tth = tth[torch.arange(B, device=self.device), idx][:, None, :]
        x = x + torch.where((gs < tth_len)[:, None, None], row_tth, tpe)

        with self._part("talker_step"):
            hidden, _ = talker_lib.decode_step(
                self.talker_params, tcfg, x, state["pos"], state["pad_count"],
                state["kv"], use_flash=self.use_flash_decode, layers=self._talker_layers,
                fused=self.use_fused_kernels, group=self.group)
            logits = talker_lib.codec_head(self.talker_params, hidden[:, 0, :], self.group)

        seen = state["seen"]
        seen.scatter_(1, token[:, None], True)  # a scalar fill: no host copy under capture
        if policy.use_rep_penalty:
            logits = apply_repetition_penalty(logits, seen, knobs[2])
        n_gen = state["n_gen"]
        n_gen += 1
        next_token = sample_logits(
            gen, logits, temperature=knobs[0], top_k=policy.top_k, top_p=knobs[1],
            use_top_p=policy.use_top_p, do_sample=policy.do_sample,
            suppress_mask=self._suppress, suppress_eos=n_gen < knobs[3].long(),
            eos_id=self.eos_id)

        state["past_hidden"].copy_(hidden)
        token.copy_(next_token)
        state["pos"] += 1
        gs += 1
        state["done"] |= next_token == self.eos_id
        return frame

    def _chunk_step(self, state: Dict, tth, tth_len, tpe, frames: torch.Tensor,
                    lens: torch.Tensor, n: torch.Tensor, i: int) -> None:
        """Step ``i`` of a chunk: its frame into ``frames[:, i]``; ``lens``
        counts each row's steps that began before its EOS, ``n`` the steps."""
        live = ~state["done"]
        frames[:, i] = self._one_step(state, tth, tth_len, tpe)
        lens += live
        n += 1

    @staticmethod
    def _tth(tth: torch.Tensor, tpe: torch.Tensor) -> torch.Tensor:
        """An empty trailing text falls back to the tts_pad embedding."""
        return tth if tth.shape[1] else tpe

    def _steps(self, state: Dict, chunk_size: int) -> int:
        """Steps of a chunk: ``chunk_size``, fewer when the cache would fill."""
        return max(0, min(chunk_size, self.max_seq_len - 1 - state["pos_host"]))

    @staticmethod
    def _own(state: Dict) -> None:
        """Copy the state's tensors once before the first step updates them
        in place: what prefill returned stays as the caller saw it."""
        if not state.get("owned"):
            for k in STATE_TENSORS:
                state[k] = state[k].clone()
            state["owned"] = True

    def _eager_chunk(self, state: Dict, tth, tth_len, tpe, chunk_size: int, steps: int):
        """Up to ``steps`` steps, eagerly, stopping once every row is done
        (a host read of ``done`` before each step)."""
        self._own(state)
        B, dev = self.batch, self.device
        frames = torch.zeros((B, chunk_size, 16), dtype=torch.int64, device=dev)
        lens = torch.zeros((B,), dtype=torch.int64, device=dev)
        n = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(steps):
            if bool(state["done"].all()):
                break
            self._chunk_step(state, tth, tth_len, tpe, frames, lens, n, i)
        return frames, n, lens, state["done"].clone()

    @torch.inference_mode()
    def decode_step(self, state: Dict, tth, tth_len, tpe):
        """One frame step, eagerly (the parity / debug path).  Returns
        (state, frame [B, 16])."""
        self._own(state)
        frame = self._one_step(state, self._tth(tth, tpe), tth_len, tpe)
        TRACE.count(self._frames_counter)
        state["pos_host"] += 1
        return state, frame

    def _chunk(self, state: Dict, tth, tth_len, tpe, chunk_size: int, vocoder=None,
               voc_state: Optional[Dict] = None, pcm16: bool = False,
               full_batch: bool = False):
        """The chunk, replayed from its graph or eager; with a vocoder, its
        frames through the codec stream.  Books the steps it may run."""
        steps = self._steps(state, chunk_size)
        tth = self._tth(tth, tpe)
        if self.graphs is not None and not self._eager_depth and steps == chunk_size:
            out = self.graphs.run(state, tth, tth_len, tpe, chunk_size, vocoder=vocoder,
                                  voc_state=voc_state, pcm16=pcm16, full_batch=full_batch)
        else:
            out = self._eager_chunk(state, tth, tth_len, tpe, chunk_size, steps)
            if vocoder is not None:
                if steps == 0:
                    shape = (self.batch, 0) if full_batch else (0,)
                    audio = torch.zeros(shape, dtype=torch.int16 if pcm16 else torch.float32,
                                        device=self.device)
                else:
                    audio, voc_state = self._vocode(vocoder, voc_state, out[0][:, :steps],
                                                    pcm16, full_batch)
                out = (*out, audio, voc_state)
        TRACE.count(self._frames_counter, steps)
        state["pos_host"] += steps
        state["planned"].append(steps)
        return (state, *out)

    @torch.inference_mode()
    def decode_chunk(self, state: Dict, tth, tth_len, tpe, chunk_size: int):
        """Run up to ``chunk_size`` steps (fewer when the cache would fill),
        stopping once every row is done.  Returns (state, frames [B,
        chunk_size, 16], n, lens [B], done [B]), all device tensors: ``n``
        the steps that ran (frames past it are zeros), ``lens[b]`` row b's
        valid frames (a row freezes at its EOS: the caller drops its frames
        after it), ``done`` each row's flag (JAX returns one flag: every row
        done or the cache full).  A replayed chunk returns its graph's
        output buffers, which its next replay overwrites: copy them first
        (the loops enqueue their copies to the host before the next chunk),
        and pass ``n`` to ``settle`` when it is read."""
        return self._chunk(state, tth, tth_len, tpe, chunk_size)

    def settle(self, state: Dict, n: int) -> None:
        """Take back from ``pos_host`` the steps that the oldest unread
        chunk booked and did not run: call with its ``n`` when it is read
        (chunks are read in the order they were dispatched)."""
        state["pos_host"] -= state["planned"].popleft() - n

    def at_limit(self, state: Dict) -> bool:
        return state["pos_host"] >= self.max_seq_len - 1

    def _vocode(self, vocoder, voc_state: Dict, frames: torch.Tensor, pcm16: bool,
                full_batch: bool = False):
        """Row 0's frames [1, n, 16] (every row's with ``full_batch``)
        through the streaming codec: (audio [n*spf] ([B, n*spf]), float32
        or with ``pcm16`` int16 PCM, voc_state')."""
        with self._part("codec_stream"):
            audio, voc_state = codec_lib.decode_stream(
                vocoder.params, vocoder.cfg, voc_state, frames if full_batch else frames[:1])
        if not full_batch:
            audio = audio[0]
        if pcm16:
            audio = torch.clamp(torch.round(audio * 32767.0), -32768.0, 32767.0
                                ).to(torch.int16)
        return audio, voc_state

    def vocode_prime(self, vocoder, voc_state: Dict, codes) -> Dict:
        """Feed reference codec frames [n, 16] (ICL voice clone) through the
        codec's stream state, discarding their audio.  The state stays on
        the device (its frame counter too), so a captured chunk reads the
        primed positions."""
        _, voc_state = vocoder.stream_feed(voc_state, codes, collect_audio=False)
        return voc_state

    @torch.inference_mode()
    def chunk_vocode(self, vocoder, state: Dict, tth, tth_len, tpe,
                     chunk_size: int, voc_state: Dict, pcm16: bool = False):
        """decode_chunk, then row 0's chunk of frames through the streaming
        codec (batch-1 streaming).  Returns (state, frames, n, lens, done,
        audio [steps*spf], voc_state'), ``steps`` the chunk's length (its
        valid samples: the first ``lens[0]*spf``).  With ``pcm16`` the audio
        is int16 PCM.  A chunk's frames past ``n`` (zeros) enter the codec
        stream only in the final chunk, where the stream ends.  A replayed
        chunk returns its graph's buffers, as ``decode_chunk`` does, and its
        stream state lives in the graph's buffers too: pass the returned
        ``voc_state`` on."""
        return self._chunk(state, tth, tth_len, tpe, chunk_size, vocoder, voc_state, pcm16)

    @torch.inference_mode()
    def chunk_vocode_batched(self, vocoder, state: Dict, tth, tth_len, tpe,
                             chunk_size: int, voc_state: Dict, pcm16: bool = False):
        """chunk_vocode for every row: the chunk's frames of all rows
        through a batched codec stream (``Vocoder.stream_state_batched``),
        in the same graph.  Returns (state, frames, n, lens, done, audio
        [B, steps*spf], voc_state'); row b's valid audio is
        ``audio[b, :lens[b]*spf]`` (the codec is causal, so the valid
        prefix is exact whatever follows it)."""
        return self._chunk(state, tth, tth_len, tpe, chunk_size, vocoder, voc_state, pcm16,
                           full_batch=True)

    # ------------------------------------------------------------------
    # continuous batching: admit one request into a running batch
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def join_row(self, state: Dict, row: int, embeds, *, policy: GenerationPolicy,
                 pred_policy: SamplingPolicy = SamplingPolicy(), pos_hint: Optional[int] = None,
                 pad_inner: Optional[int] = None) -> Dict:
        """Admit a request, its prompt [1, T, H] (numpy or tensor), into
        ``row`` of a running batch.  The prompt is left-padded to its
        bucket ``Tb`` (or, with ``pad_inner``, is already: ``T`` must then
        be a bucket), prefilled into a cache of ``Tb`` slots and written into
        the row's slots ``[pos - Tb, pos)``, so that it ends at the shared
        position ``pos``: slot s then holds RoPE position ``s - pad_count``
        with the row's ``pad_count = pos - Tb + pad_inner``, what the shared
        step computes for it.  The row's token (sampled from the prompt),
        hidden, counters, seen mask and done flag restart.  Everything is
        written in place, into the tensors a captured chunk replays on.
        ``pos_hint`` is the batch's position as the host knows it (read from
        the device when not given): a bucket past it raises."""
        B, T, H = embeds.shape
        if B != 1:
            raise ValueError("join_row admits one request at a time")
        if pad_inner is None:
            Tb = bucket_for(T)
            pad_inner = Tb - T
        else:
            Tb = T
            if Tb not in PREFILL_BUCKETS:
                raise ValueError(f"pre-padded join embeds length {Tb} is not a prefill "
                                 f"bucket {PREFILL_BUCKETS}")
        pos = int(state["pos"]) if pos_hint is None else pos_hint
        if Tb > pos:
            raise ValueError(f"cannot join: prompt bucket {Tb} exceeds current batch "
                             f"position {pos} (row would underflow the cache)")
        embeds = upload(embeds, self.device, self.dtype)
        if Tb > T:
            embeds = torch.cat([embeds.new_zeros((1, Tb - T, H)), embeds], dim=1)
        dev = self.device
        self._own(state)
        pad = torch.full((1,), pad_inner, dtype=torch.int32, device=dev)
        tiny = talker_lib.new_kv_cache(self.talker_cfg, 1, Tb, self.dtype, dev,
                                       kv_quant=self.kv_quant, tp=self.tp)
        last, logits, tiny = talker_lib.prefill(self.talker_params, self.talker_cfg, embeds,
                                                pad, tiny, layers=self._talker_layers,
                                                group=self.group)
        # the splice ends at the device's position (its start clamped into
        # the cache, as JAX's dynamic_update_slice clamps)
        start = state["pos"].long() - Tb
        slots = start.clamp(0, self.max_seq_len - Tb) + torch.arange(Tb, device=dev)
        talker_lib.splice_row(state["kv"], row, tiny, slots)
        knobs = make_knobs(policy, pred_policy, dev)
        st = policy.static
        token = sample_logits(
            state["generator"], logits, temperature=knobs[0], top_k=st.top_k,
            top_p=knobs[1], use_top_p=st.use_top_p, do_sample=st.do_sample,
            suppress_mask=self._suppress, suppress_eos=knobs[3] > 0, eos_id=self.eos_id)
        state["past_hidden"][row] = last[0].to(state["past_hidden"].dtype)
        state["token"][row] = token[0]
        state["pad_count"][row] = (start + pad_inner).to(torch.int32)[0]
        for name in ("gen_step", "seen", "n_gen"):
            state[name][row] = 0
        state["done"][row] = token[0] == self.eos_id
        return state

    def warm_join(self, prompt_len: int) -> int:
        """The bucket ``join_row`` prefills ``prompt_len`` tokens at.  Eager
        PyTorch compiles nothing ahead (the JAX engine's AOT compile is not
        ported); this validates the length.  Returns the bucket."""
        Tb = bucket_for(prompt_len)
        if Tb > self.max_seq_len:
            raise ValueError(f"join bucket {Tb} exceeds max_seq_len {self.max_seq_len}")
        return Tb

    # ------------------------------------------------------------------
    # warmup: capture the chunk graphs ahead of the requests that replay them
    # ------------------------------------------------------------------

    def _warm_chunks(self, state: Dict, Tt: int, chunk_sizes, vocoder, policy,
                     pred_policy, prefill_len: int, gen) -> Dict:
        """decode_chunk (and chunk_vocode, or above batch 1
        chunk_vocode_batched) at each chunk size, for trailing text of bucket
        ``Tt``; a new prefill when the cache would cap a chunk.  Returns the
        state."""
        H = self.talker_cfg.hidden_size
        tth = torch.zeros((self.batch, Tt, H), dtype=self.dtype, device=self.device)
        tpe = torch.zeros((self.batch, 1, H), dtype=self.dtype, device=self.device)
        embeds = torch.zeros((self.batch, prefill_len, H), dtype=self.dtype,
                             device=self.device)
        for cs in dict.fromkeys(chunk_sizes):
            for with_vocoder in (False, True) if vocoder is not None else (False,):
                if self._steps(state, cs) < cs:
                    self.release(state)
                    state = self.prefill(embeds, gen, policy, pred_policy)
                if with_vocoder and self.batch > 1:
                    self.chunk_vocode_batched(vocoder, state, tth, 0, tpe, cs,
                                              vocoder.stream_state_batched(self.batch))
                elif with_vocoder:
                    self.chunk_vocode(vocoder, state, tth, 0, tpe, cs, vocoder.stream_state())
                else:
                    self.decode_chunk(state, tth, 0, tpe, cs)
        return state

    def warmup(self, prefill_len: int, tth_len: int, policy: GenerationPolicy,
               pred_policy: SamplingPolicy, chunk_sizes=(8,), vocoder=None) -> float:
        """Capture the chunk graphs (and, with a ``vocoder``, the decode +
        vocode graphs) at the engine's batch, at ``chunk_sizes`` for
        ``tth_len``'s trailing-text bucket, and run each once.  The prefill
        is eager, so nothing of it is captured.  On CPU tensors the chunks
        run eagerly and nothing is captured.  Returns seconds."""
        t0 = time.time()
        bucket_for(prefill_len)
        gen = torch.Generator(device=self.device).manual_seed(0)
        prefill_len = max(prefill_len, 1)
        H = self.talker_cfg.hidden_size
        state = self.prefill(torch.zeros((self.batch, prefill_len, H), dtype=self.dtype,
                                         device=self.device), gen, policy, pred_policy)
        try:
            state = self._warm_chunks(state, bucket_for(max(tth_len, 1), TTH_BUCKETS),
                                      chunk_sizes, vocoder, policy, pred_policy,
                                      prefill_len, gen)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self.release(state)
        self.warmed_up = True
        return time.time() - t0

    def warmup_all(self, policy: GenerationPolicy, pred_policy: SamplingPolicy,
                   chunk_sizes=(8, 16), max_prefill: Optional[int] = None,
                   max_tth: Optional[int] = None, vocoder=None) -> float:
        """Capture every (trailing-text bucket x chunk size) graph, with the
        vocoder's too when one is given, so that no request captures
        mid-stream.  The warm-up prompt is ``max_prefill`` tokens long (the
        smallest prefill bucket by default): the prefill is eager, so no
        bucket of it is captured.  Returns seconds."""
        t0 = time.time()
        prefill_len = min(max_prefill or PREFILL_BUCKETS[0], self.max_seq_len - 1)
        bucket_for(prefill_len)
        gen = torch.Generator(device=self.device).manual_seed(0)
        H = self.talker_cfg.hidden_size
        state = self.prefill(torch.zeros((self.batch, prefill_len, H), dtype=self.dtype,
                                         device=self.device), gen, policy, pred_policy)
        try:
            for Tt in (b for b in TTH_BUCKETS if b <= (max_tth or TTH_BUCKETS[-1])):
                state = self._warm_chunks(state, Tt, chunk_sizes, vocoder, policy,
                                          pred_policy, prefill_len, gen)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self.release(state)
        self.warmed_up = True
        return time.time() - t0
