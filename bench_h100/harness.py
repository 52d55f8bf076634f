"""One run of one cell: set-up, the measured window, the readings, the check.

Everything a cell is made of is found by name: its configuration file (the
``file`` of its ``configs`` entry) with the program's path in its
``bench.path``, its counts in ``bench.counts``
(``bench_h100/counts/<counts>.py``) and the plain reference that judges it
in ``bench.reference`` (``bench_h100/reference/<reference>.py``), its traffic mix
(``bench_h100/traffic/<traffic>.json``) with its driver
(``bench_h100/drivers/<driver>.py``), the limits of its check
(``bench_h100/limits/<workload>.json``) and a reader for each metric
(``bench_h100/metrics/<metric>.py``, a ``read(ctx)`` that returns a number
or None when it finds nothing to read; a metric ``<base>.<part>`` with no
file of its own is read by ``<base>``'s, as ``frames_per_s.b1`` by
``frames_per_s.py``).

Adding a configuration takes new files only:

- ``configs/<config>.json``: the port's configuration, equal to the port's
  preset of that name, with ``bench.reference``, ``bench.counts``,
  ``bench.path``, ``bench.max_seq_len`` and ``bench.reduced`` (the same keys
  as the ``BENCHMARK.json`` entry's ``reduced``);
- ``reference/<reference>.py``: a ``Reference`` that subclasses
  ``reference/qwen3tts.py``'s and replaces ``talker_stack`` (or a whole
  reference), importing nothing of the program;
- ``counts/<counts>.py``: the names listed in ``counts/qwen3tts.py``'s
  docstring;
- ``limits/<workload>.json``, and ``traffic/<mix>.json`` for a new mix;
- ``BENCHMARK.json`` entries of the new cell's metrics under a suffix
  that the base name's reader reads (``frames_per_s.<suffix>``, as
  ``.b1`` is read today), and new readers only for new spans.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Dict, Optional

import torch

import check as check_lib
import devtrace
import drivers
from traffic import load_mix, plan, voices
from weights import make_weights

HERE = Path(__file__).resolve().parent
REFERENCES = HERE / "reference"
# the program's path, as the configuration's ``bench.path`` names it, and
# the API's default of each key
PATH = {"flash_decode": True, "fused_kernels": False, "micro_kernel": False,
        "cuda_graphs": True, "quantize": None, "kv_quant": False}


def _load_file(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_file(name: str) -> Path:
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    if not path.is_file():
        raise ValueError(f"no reader for metric {name!r} in bench_h100/metrics/")
    return path


def load_reader(name: str):
    path = reader_file(name)
    return _load_file(path, "metric_" + path.stem.replace(".", "_")).read


def _load_named(cfg: Dict, kind: str, folder: Path):
    """The module ``<folder>/<name>.py`` that the configuration's
    ``bench.<kind>`` names; a missing or unknown name raises."""
    name = cfg["bench"].get(kind)
    if not isinstance(name, str) or not (folder / f"{name}.py").is_file():
        raise ValueError(f"no {kind} {name!r} in bench_h100/{kind}/")
    return _load_file(folder / f"{name}.py", f"{kind}_{name}")


def load_counts(cfg: Dict):
    """The counts module the configuration names (``bench.counts``)."""
    return _load_named(cfg, "counts", HERE / "counts")


def load_reference(cfg: Dict):
    """The ``Reference`` class of the plain reference the configuration
    names (``bench.reference``), from ``REFERENCES``."""
    return _load_named(cfg, "reference", REFERENCES).Reference


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench: Dict, root: Path, workload: str):
    """(configuration dict, mix dict, limits dict) of ``workload``."""
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    mix = load_mix(HERE / "traffic" / f"{wl['traffic']}.json")
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return cfg, mix, limits


def program_path(cfg: Dict) -> Dict:
    """The configuration's ``bench.path`` over the API's defaults; a key the
    harness does not know raises, so no path is dropped unseen."""
    path = cfg["bench"].get("path", {})
    unknown = sorted(set(path) - set(PATH))
    if unknown:
        raise ValueError(f"unknown bench.path keys {unknown}; known: {sorted(PATH)}")
    return dict(PATH, **path)


def engine_options(path: Dict) -> Dict:
    """``Engine`` keywords of a program path (CUDA graphs apart)."""
    return {"use_flash_decode": path["flash_decode"], "use_fused_kernels": path["fused_kernels"],
            "use_micro_kernel": path["micro_kernel"], "kv_quant": path["kv_quant"]}


def build_model(cfg: Dict, cfg_obj, params: Dict, seed: int, batch: int,
                control: Optional[str] = None):
    """``FasterQwen3TTS`` on ``params`` as the configuration's path runs them:
    stored as ``quantize`` says (or as ``control``), the KV cache as
    ``kv_quant`` says, and, where the path is not the API's default, its
    engines at 1 and ``batch`` rows built with the path's options."""
    from qwen3tts_tpu_torch.api.model import FasterQwen3TTS
    from qwen3tts_tpu_torch.ops.quant import quantize_bundle
    from qwen3tts_tpu_torch.runtime.engine import Engine

    path = program_path(cfg)
    quantize = control or path["quantize"]
    served = quantize_bundle(params, quantize) if quantize else params
    model = FasterQwen3TTS(cfg_obj, served, max_seq_len=cfg["bench"]["max_seq_len"],
                           seed=seed, kv_quant=path["kv_quant"])
    engines = {k: path[k] for k in ("flash_decode", "fused_kernels", "micro_kernel",
                                    "cuda_graphs")}
    if engines != {k: PATH[k] for k in engines}:
        def engine(rows):
            return Engine(served["talker"], served["predictor"], cfg_obj,
                          max_seq_len=model.max_seq_len, batch=rows,
                          use_cuda_graphs=None if path["cuda_graphs"] else False,
                          **engine_options(path))

        model.engine = engine(1)
        if batch > 1:
            model._batch_engines[batch] = engine(batch)
    return model


def _trace_data(driver, ev0, window_ms: float, log0: int) -> Dict:
    """The recording graphs' replays in the window (CUDA events, steps run,
    kernel nodes walked from their graphs) and the eager spans."""
    from qwen3tts_tpu_torch.ops.cuda_build import KERNEL_SYMBOLS

    torch.cuda.synchronize()
    graphs = driver.engine.graphs
    out = {"intervals": [], "replay_ms": 0.0, "steps": 0, "nodes": 0, "eager_ms": 0.0}
    walked = {}
    needles = list(KERNEL_SYMBOLS.values())
    for g, n, start, end in graphs.log[log0:]:
        s, e = ev0.elapsed_time(start), ev0.elapsed_time(end)
        if e <= 0 or s >= window_ms:
            continue
        n = int(n)
        out["intervals"].append((s, e))
        out["replay_ms"] += min(e, window_ms) - max(s, 0.0)
        if id(g) not in walked:
            walked[id(g)] = graphs.kernel_nodes(g, needles)
        top, bodies = walked[id(g)]
        out["steps"] += n
        out["nodes"] += top[-1] + sum(b[-1] for b in bodies[:n])
    for _name, start, end in driver.spans.spans:
        s, e = ev0.elapsed_time(start), ev0.elapsed_time(end)
        if e > 0 and s < window_ms:
            out["intervals"].append((s, e))
            out["eager_ms"] += min(e, window_ms) - max(s, 0.0)
    return out


def run(bench: Dict, root: Path, workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", control: Optional[str] = None,
        fp8_audio: bool = False, cell_parts=None) -> Dict:
    """One run; returns the result dict (metrics, device, checks, breakdown).
    ``control`` runs the program on its own lower-precision path
    (``quantize=control``) in place of the configuration's; ``cell_parts``
    gives (configuration, mix, limits) in place of the files (the CPU tests'
    tiny cells)."""
    from qwen3tts_tpu_torch.core.config import TTSModelConfig

    cfg, mix, limits = cell_parts or cell(bench, root, workload)
    cuda = torch.device(device).type == "cuda"
    cfg_obj = TTSModelConfig.from_dict(cfg)
    counts = load_counts(cfg)
    reference = load_reference(cfg)
    driver_cls = drivers.load(mix["driver"])
    params = make_weights(cfg_obj, seed, device)
    model = build_model(cfg, cfg_obj, params, seed, driver_cls.rows(mix), control)
    vox = voices(mix, seed)
    for v in vox:  # the voices' x-vectors, cached as a server caches its voices
        model._voice_prompt((v, mix["voices"]["sample_rate"]), "", True, True)
    reqs = plan(mix, seed, seconds)
    driver = driver_cls(model, mix, vox, trace and cuda, seed)
    driver.setup(reqs)
    captures0 = driver.captures()
    log0 = len(driver.engine.graphs.log) if trace and cuda else 0
    if cuda:
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    recs = driver.window(reqs, t0, seconds)
    if cuda:
        torch.cuda.synchronize()
    ends = [r["end"] for r in recs if r.get("end") is not None]
    closed = mix["arrivals"]["kind"] == "closed"
    window_s = max(ends) - t0 if closed and ends else seconds
    ctx = {"recs": recs, "t0": t0, "seconds": seconds, "window_s": window_s,
           "setup_s": setup_s, "cfg": cfg, "mix": mix, "counts": counts,
           "devtrace": devtrace}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    if trace and cuda:
        ctx["captures_in_window"] = None if captures0 is None else \
            driver.captures() - captures0
        ctx["trace"] = _trace_data(driver, ev0, window_s * 1e3, log0)
        prof = devtrace.eager_profile(model, cfg_obj, mix, driver.batch, seed,
                                      engine_options(program_path(cfg)))
        ctx["profile"] = prof
        device_info["busy_s"] = prof["busy_s"]
        device_info["window_s"] = prof["window_s"]
    batch_pos = getattr(getattr(driver, "codes", None), "max_pos", None)
    driver.close()
    del driver, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check_lib.judge(reference, params, cfg, vox, recs,
                              mix["check"]["requests"], seed, fp8_audio=fp8_audio)
    if batch_pos is not None:
        numbers["batch_max_pos"] = float(batch_pos)
    names = [m for m in (bench["per_layer"] if trace else bench["end_to_end"])
             if applies(m, workload)]
    metrics = {}
    for m in names:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": check_lib.verdict(numbers, limits),
           "attempted": len(recs),
           "failed": int(numbers["unfinished"]),
           "metrics": metrics, "device": device_info,
           "numbers": numbers, "limits": limits}
    if trace and cuda:
        out["breakdown"] = {"device_ops": ctx["profile"]["device_ops"],
                            "idle_gaps": ctx["profile"]["idle_gaps"]}
    return out
