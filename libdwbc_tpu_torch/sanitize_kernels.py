"""Small calls of the warp-per-problem kernels, ``psd_inverse``,
``qp_solve`` and ``tick_qpchain``, for NVIDIA's compute-sanitizer:

    compute-sanitizer --tool racecheck python -m libdwbc_tpu_torch.sanitize_kernels
    compute-sanitizer --tool memcheck python -m libdwbc_tpu_torch.sanitize_kernels

``psd_inverse`` at n = 33, 39 and 64 on 5 matrices (two blocks, the second
partly empty); ``qp_solve`` cold and warm on 5 problems at the tick's
level-0 shape (n = 12, m = 86, 33 mirrored pairs: four problems per block)
and at the largest it takes (n = 24, m = 512, with 33 mirrored pairs three
per block, without two), on random strictly feasible problems; and
``tick_qpchain`` on 5 scenarios of the flagship in each mode it serves:
static cold and warm, masked (the three support hypotheses) and servo'd
(f* read from the prestage buffer), its inputs from the plain versions on
the CPU (float32), so no other kernel of the port runs.  Each call is synchronised and checked for finite output.
Needs a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import entry
from .model.compile import RobotModel
from .ops import linalg_cuda, qp_cuda
from .ops.tick_cuda import TickKernels
from .ops.tick_kernel import TickProgram
from .wbc.fused import FusedTick
from .wbc.pipeline import standard_tocabi_config

NB = 5


def _to(x, dev):
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    return x.to(dev)


def _el(a):
    return torch.as_tensor(np.ascontiguousarray(a.T))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sanitize_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for n in (33, 39, 64):
        U, _ = np.linalg.qr(rng.standard_normal((NB, n, n)))
        A = torch.as_tensor((U * np.logspace(0, 3, n)) @ np.swapaxes(U, -1, -2),
                            dtype=torch.float32, device=dev)
        out = linalg_cuda.psd_inverse(A)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        print(f"psd_inverse n {n} batch {NB}: done")

    for n, k, extra, mr in ((12, 33, 20, 33), (24, 33, 446, 33), (24, 33, 446, 0)):
        m = 2 * k + extra
        Q = rng.standard_normal((NB, n, n))
        Bm = rng.standard_normal((NB, k, n))
        C = np.concatenate([Bm, -Bm, rng.standard_normal((NB, extra, n))], axis=1)
        d = np.einsum("bmn,bn->bm", C, rng.standard_normal((NB, n))) + rng.uniform(0.05, 2, (NB, m))
        H, g, C, d = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
            Q @ np.swapaxes(Q, -1, -2) * 0.1 + np.eye(n), rng.standard_normal((NB, n)), C, d))
        x, _, lam = qp_cuda.qp_solve(H, g, C, d, iters=12, mirror=mr)
        out = qp_cuda.qp_solve(H, g, C, d, x, lam, iters=7, mirror=mr)
        torch.cuda.synchronize()
        assert all(torch.isfinite(t).all() for t in out)
        print(f"qp_solve n {n} m {m} mirror {mr} batch {NB}, cold and warm: done")

    model = RobotModel.load(str(entry.MODEL_PATH))
    cfg = standard_tocabi_config(model, qp_iters=12)
    q0, _, f0 = entry._example_inputs(model)
    q = np.tile(q0, (NB, 1))
    q[:, 6:39] += 0.02 * rng.standard_normal((NB, 33)).astype(np.float32)
    fs = [np.tile(f, (NB, 1)) for f in f0]
    mq, _, mfs, masks = entry._masked_inputs(model, NB, seed=0)
    sq, sqd, sfs, servos = entry._servo_inputs(model, NB, seed=0)
    for mode in ("static", "masked", "servo"):
        masked = mode == "masked"
        plain = TickProgram(model, cfg, "cpu", torch.float32, masked=masked)
        kern = TickKernels(TickProgram(model, cfg, dev, torch.float32, masked=masked))
        if mode == "servo":
            tick = FusedTick(model, cfg, "cpu", torch.float32, backend="torch")
            pre = plain.prestage_servo(_el(sq), None, _el(sqd), [_el(f) for f in sfs],
                                       tick._servos_el(servos, NB))
            fstars = None
        else:
            pre = plain.prestage(_el(mq if masked else q), _el(masks) if masked else None)
            fstars = _to([_el(f) for f in (mfs if masked else fs)], dev)
        res = kern.qpchain(_to(pre, dev), fstars, None, 12)
        res_w = kern.qpchain(_to(pre, dev), fstars, res["warm_out"], 7)
        torch.cuda.synchronize()
        for r in (res, res_w):
            assert torch.isfinite(r["torque_cmd"]).all()
        print(f"tick_qpchain {mode} batch {NB}, cold and warm: done")


if __name__ == "__main__":
    main()
