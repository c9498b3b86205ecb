"""Build variants of the bf16 flash kernels' source and time them on one GPU.

    python3 paddle_tpu_torch/tools/flash_variants.py [NAME ...]

Each variant (``VARIANTS`` below, all of them by default) is
``csrc/flash_attention_bf16.cu`` with some text replaced: the design
choices the source note gives numbers for, each undone. Each is built with
the port's nvcc flags into ``build/variants/`` (its ptxas spill lines
printed), checked against the plain versions at [8, 16, 2048, 128] bf16
causal (every row of out, dq, dk and dv within 2 bf16 ulps, delta within
1e-3 of its scale) and timed by CUDA-graph replay: the forward, the dq
kernel (with delta) and the dk/dv kernel apart, at that shape and at the
GPT-MoE one, [8, 12, 1024, 64]. Compare variants only within one run:
two runs may land on two cards.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as FA  # noqa: E402


VARIANTS = {
    "as_is": [],
    # the consumers' waits with the producer's watchdog clock
    "consumer_watchdog": [("mbar_wait(", "mbar_wait_guarded(")],
    # dq keeps its Q and dO descriptors in registers across the loop
    "no_opaque": [('  asm volatile("" : "+r"(addr));\n', "")],
    # 24 registers for the producer, 240 for each consumer
    "regs_24_240": [("PRODUCER_REGS = 40", "PRODUCER_REGS = 24"),
                    ("CONSUMER_REGS = 232", "CONSUMER_REGS = 240")],
}


def kernels(lib, q, k, v, dout, out, lse, delta):
    """Closures launching the forward, dq and dk/dv of ``lib`` on these
    tensors (causal), each on the stream current at its call."""
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i] * 6 + [f] + [i] * 4 + [ptr]
    lib.ptt_flash_fwd.argtypes = [ptr] * 8 + tail
    lib.ptt_flash_bwd_dq.argtypes = [ptr] * 10 + tail
    lib.ptt_flash_bwd_dkv.argtypes = [ptr] * 10 + tail
    b, h, s, d = q.shape
    res = [torch.empty_like(q), torch.empty(b, h, s, device=q.device),
           torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]

    def geo():
        return (b * h, s, s, d, 1, 1, d ** -0.5, h, 0, FA.NO_WINDOW,
                FA.NO_WINDOW, torch.cuda.current_stream().cuda_stream)
    o, l, dq, dk, dv = (x.data_ptr() for x in res)
    qp, kp, vp, gp = (x.data_ptr() for x in (q, k, v, dout))
    calls = (
        lambda: lib.ptt_flash_fwd(qp, kp, vp, o, l, None, None, None, *geo()),
        lambda: lib.ptt_flash_bwd_dq(qp, kp, vp, gp, out.data_ptr(),
                                     lse.data_ptr(), delta.data_ptr(), dq,
                                     None, None, *geo()),
        lambda: lib.ptt_flash_bwd_dkv(qp, kp, vp, gp, lse.data_ptr(),
                                      delta.data_ptr(), dk, dv, None, None,
                                      *geo()))
    return calls, res


def main(argv=None):
    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: no CUDA device")
    print(S._card_line(), flush=True)
    built = _build.build_variants("flash_attention_bf16",
                                  {n: VARIANTS[n] for n in names})
    dev = torch.device("cuda")
    cases = []
    for shape in ((8, 16, 2048, 128), (8, 12, 1024, 64)):
        q, k, v, dout = S._flash_case(torch, dev, *shape[:3], shape[2],
                                      shape[3], torch.bfloat16, 30)
        out, lse = FA.flash_forward_plain(q, k, v, True)
        delta = (dout.float() * out.float()).sum(-1)
        cases.append((shape, (q, k, v, dout, out, lse)))
        if shape[3] == 128:
            want = FA.flash_backward_plain(q, k, v, out, lse, dout, True)
            ref = (out, delta) + want
    for name, path in built.items():
        lib = ctypes.CDLL(str(path))
        times = []
        for shape, (q, k, v, dout, out, lse) in cases:
            delta = torch.empty(lse.shape, device=dev)
            calls, res = kernels(lib, q, k, v, dout, out, lse, delta)
            if any(call() for call in calls):
                raise RuntimeError(f"{name}: a launch failed")
            torch.cuda.synchronize()
            if shape[3] == 128:
                S._check(f"{name} delta", delta, ref[1],
                         1e-3 * max(1.0, float(ref[1].abs().max())))
                for label, got, w in zip(("out", "dq", "dk", "dv"),
                                         [res[0]] + res[2:],
                                         (ref[0],) + ref[2:]):
                    S._check_rows(f"{name} {label}", got, w, 2)
            times.append([S._graph_ms(c, iters=5, reps=3) for c in calls])
        print(f"TIME {name}: " + "; ".join(
            f"d{shape[3]} fwd {t[0]:.4f} dq {t[1]:.4f} dkv {t[2]:.4f} ms"
            for (shape, _), t in zip(cases, times)), flush=True)


if __name__ == "__main__":
    main()
