"""The plain reference: exact nearest neighbors and exact pair distances.

Plain torch in float64 (TF32 is switched off as well, for any float32
matmul), computed in blocks on the given device, from the data and queries
the benchmark generated. It imports nothing of the program under test and
takes nothing the program made: where the program stores rows in bfloat16,
the reference rounds the data to bfloat16 itself.
"""

from __future__ import annotations

import numpy as np
import torch

# the forms a stored row may take: the values as generated, or rounded to
# bfloat16 (the bf16 node-block tier)
_FORMS = {
    "f32": lambda x: x,
    "u8": lambda x: x,
    "bf16": lambda x: x.to(torch.bfloat16).to(torch.float64),
}


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact_knn(x: np.ndarray, q: np.ndarray, k: int, device,
              q_block: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """The k nearest rows of x to each query by squared L2, in float64
    → (distances [nq, k] ascending, row ids [nq, k] int64)."""
    _no_tf32()
    xd = torch.from_numpy(np.ascontiguousarray(x)).to(device, torch.float64)
    xsq = (xd * xd).sum(-1)
    out_d, out_i = [], []
    for s in range(0, len(q), q_block):
        qd = torch.from_numpy(np.ascontiguousarray(q[s : s + q_block])).to(
            device, torch.float64)
        d = (qd * qd).sum(-1, keepdim=True) + xsq[None, :] - 2.0 * (qd @ xd.T)
        dk, ik = torch.topk(d, k, dim=-1, largest=False, sorted=True)
        out_d.append(dk.cpu().numpy())
        out_i.append(ik.cpu().numpy())
        del d
    return np.concatenate(out_d), np.concatenate(out_i)


def pair_dists(x: np.ndarray, q: np.ndarray, qid: np.ndarray, labels: np.ndarray,
               forms: tuple[str, ...], device, block: int = 1 << 21) -> dict:
    """Exact squared-L2 distance of query q[qid[r]] to row x[labels[r, j]],
    for every form of the stored row in `forms`, by direct differences in
    float64 → {form: [R, k] float64}, plus "scale": |q|^2 + |x|^2 of each
    pair. Labels outside [0, len(x)) read row 0 (the caller masks them)."""
    _no_tf32()
    xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    qd = torch.from_numpy(np.ascontiguousarray(q)).to(device, torch.float64)
    r, k = labels.shape
    lab = np.where((labels >= 0) & (labels < len(x)), labels, 0).reshape(-1)
    rows_q = np.repeat(qid.astype(np.int64), k)
    out = {f: np.empty(r * k) for f in (*forms, "scale")}
    for s in range(0, r * k, block):
        li = torch.from_numpy(lab[s : s + block]).to(device)
        qi = torch.from_numpy(rows_q[s : s + block]).to(device)
        xr = xd[li].to(torch.float64)
        qr = qd[qi]
        for f in forms:
            diff = _FORMS[f](xr) - qr
            out[f][s : s + block] = (diff * diff).sum(-1).cpu().numpy()
        out["scale"][s : s + block] = ((xr * xr).sum(-1) + (qr * qr).sum(-1)).cpu().numpy()
    return {f: v.reshape(r, k) for f, v in out.items()}
