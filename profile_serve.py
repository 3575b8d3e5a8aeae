#!/usr/bin/env python3
"""Where the time of one full-width 800x800 frame goes, on one GPU.

    python3 profile_serve.py [--preset blocked|tpu|hashnerf|lerf] [--frames 2]
                             [--trace serve_trace.json]

Renders a serving cell of chip_smoke.py at 800x800 once to warm up, then
``--frames`` more under torch.profiler: ``blocked`` (the default) is
hashnerf_blocked_preset with n_importance=0 and the 128^3 occupancy grid, 64
samples, auto two-class budget; ``tpu`` is hashnerf_tpu_preset (small-table
random scheme, 64 coarse + 192 importance samples, chunk 32,768, no grid),
``hashnerf`` hashnerf_preset (the same with the 16 x 2^19 f32 table through
the large-table kernels), both from seeded random weights; ``lerf``
hashnerf_preset(use_lerf=True) (E = 768), whose frame adds the language
branch with relevancy against three random prompts. Spans around the hash
encoder, the SH direction encoder and the NeRFSmall field (and the language
hash encoder and LeRF field) split the device time by layer; the rest of
the frame (rays, occupancy prior or importance sampling and merge, cone
scatter, compositing, scatter back to image order) is the remainder. Prints, per frame: the wall time, the
device busy time (sum of kernel times), the idle share, the time in each
span, and the 25 kernels with the most device time. Needs a CUDA device.
"""
import argparse
import bisect
import subprocess
import sys
import time

import chip_smoke as C


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=("blocked", "tpu", "hashnerf",
                                         "lerf"), default="blocked")
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace of the profiled frames here")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        print("profile_serve: CUDA is not available", file=sys.stderr)
        return 1
    from nerfpp_tpu_torch.config import (TrainParams, hashnerf_blocked_preset,
                                         hashnerf_preset, hashnerf_tpu_preset)
    from nerfpp_tpu_torch.executor import NeRFExecutor
    from nerfpp_tpu_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all()

    dev = torch.device("cuda")
    if args.preset == "blocked":
        ex = NeRFExecutor(hashnerf_blocked_preset(
            n_importance=0, use_occupancy_grid=True), device=dev)
        ex.initialize(C.BBOX, seed=C.SEED)
        ex.load_state({"occupancy": C.sphere_grid(128, 0.5, 10.0, dev)})
        tp = TrainParams(n_samples=64, chunk=65536)
    else:
        ex = NeRFExecutor(hashnerf_tpu_preset() if args.preset == "tpu"
                          else hashnerf_preset(
                              use_lerf=args.preset == "lerf"), device=dev)
        ex.initialize(C.BBOX, seed=C.SEED)
        tp = TrainParams()
    spans = {"hash_encode": ex.embedder, "field_mlp": ex.model}
    if ex.lang_model is not None:
        g = torch.Generator().manual_seed(C.SEED)
        prompts = torch.randn(3, ex.params.lang_embed_dim, generator=g)
        ex.set_lerf_prompts(prompts[:1], prompts[1:])
        spans["le_encode"] = ex.lang_embedder
        field = ex.lang_model.embed_and_density

        def field_spanned(x):
            with record_function("le_field"):
                return field(x)
        ex.lang_model.embed_and_density = field_spanned
    for name, mod in spans.items():
        def enter(_m, _a, name=name):
            _m._span = record_function(name)
            _m._span.__enter__()

        def leave(_m, _a, _o):
            _m._span.__exit__(None, None, None)
        mod.register_forward_pre_hook(enter)
        mod.register_forward_hook(leave)
    sh = ex.embeddirs

    def sh_spanned(dirs):
        with record_function("sh_encode"):
            return sh(dirs)
    sh_spanned.output_dims = sh.output_dims
    ex.embeddirs = sh_spanned
    k, pose = C.camera(800)
    ex.render_view(pose, 800, 800, k, tp)                 # warm-up + probe
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            ex.render_view(pose, 800, 800, k, tp)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
    if args.trace:
        prof.export_chrome_trace(args.trace)

    # the spans show up twice: as CPU ranges and as ranges on the card's
    # timeline. Busy time is the sum of the card's own events (kernels,
    # copies, memsets); each is attributed to the span range it starts in.
    names = ("hash_encode", "sh_encode", "field_mlp", "le_encode",
             "le_field")
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in dev_events if e.name in names)
    work = [e for e in dev_events if e.name not in names]
    busy_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3 / args.frames
    span_ms = dict.fromkeys(names, 0.0)
    starts = [r[0] for r in ranges]
    for e in work:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < ranges[i][1]:
            span_ms[ranges[i][2]] += e.time_range.elapsed_us() / 1e3
    print(f"[profile] {args.preset} | {smi} | frame wall {wall_ms:.3f} ms | "
          f"device busy "
          f"{busy_ms:.3f} ms | idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.4f}")
    rest = busy_ms
    for name, ms in span_ms.items():
        ms /= args.frames
        rest -= ms
        print(f"[profile] span {name}: {ms:.3f} ms/frame on the device "
              f"({ms / busy_ms:.4f} of busy)")
    print(f"[profile] outside the spans (rays, sampling, compositing, "
          f"scatter): {rest:.3f} ms/frame ({rest / busy_ms:.4f} of busy)")
    print("[profile] top device kernels by time per frame:")
    kern = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA and a.key not in names]
    kern.sort(key=lambda a: a.self_device_time_total, reverse=True)
    for a in kern[:25]:
        ms = a.self_device_time_total / 1e3 / args.frames
        print(f"[profile]   {ms:9.3f} ms  {a.count // args.frames:6d}x  "
              f"{a.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
