"""Compile-check and dry-run entry points (counterpart of the repo's
__graft_entry__.py): the flagship step at a small size, and the full
sharded pipeline over n ranks with a decode check.

    python -m spiral_tpu_torch.graft_entry [--device cpu]
    torchrun --nproc-per-node N -m spiral_tpu_torch.graft_entry

runs entry()'s step once, then dryrun_multichip over the world (a world
of one without torchrun).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from .params import B_I, P_I, Params, preset
from .arith import ntt
from .dist import multihost
from .server.firstdim import finish_output, multiply_query_by_db
from .server.fold import fold_ciphertexts


def _residues(rng: np.random.Generator, shape: tuple, limb_axis: int,
              device) -> torch.Tensor:
    """Uniform residues mod (P_I, B_I) along limb_axis (of size 2)."""
    mods = np.array([P_I, B_I], dtype=np.int64).reshape(
        [2 if a == limb_axis % len(shape) else 1 for a in range(len(shape))])
    x = rng.integers(0, 1 << 28, size=shape, dtype=np.int64) % mods
    return torch.from_numpy(x.astype(np.int32)).to(device)


def entry(device="cuda"):
    """(fn, example_args): the flagship step of the Spiral server at
    `tiny`, first-dimension multiply (K2), inverse NTT (K1) and GSW
    folding (K3), on random residues drawn from numpy seed 0 on
    `device`: db (2, d, K, num_per*n2), query_k (K, n1, 2, d), q_pos and
    q_neg (nu_2, n1, m2, 2, d)."""
    params = preset("tiny")
    rng = np.random.default_rng(0)

    def step(db, query_k, q_pos, q_neg):
        res = multiply_query_by_db(db, query_k)
        cts = ntt.inverse(finish_output(res, params.num_per, params.n2))
        return fold_ciphertexts(cts, q_pos, q_neg, params)

    p = params
    d, K = p.poly_len, p.dim0 * p.n0
    db = _residues(rng, (2, d, K, p.num_per * p.n2), 0, device)
    qk = _residues(rng, (K, p.n1, 2, d), -2, device)
    qp, qn = (_residues(rng, (p.further_dims, p.n1, p.m2, 2, d), -2, device)
              for _ in range(2))
    return step, (db, qk, qp, qn)


def dryrun_params(n_devices: int) -> Params:
    """The JAX dry run's parameters for n_devices: nu_1 4, nu_2 max(2,
    log2 of the power-of-two part of n_devices), t_gsw 9, d 2048."""
    db_axis = n_devices & -n_devices           # largest pow2 divisor
    return Params(nu_1=4, nu_2=max(2, db_axis.bit_length() - 1), p_db=256,
                  q_prime_bits=20, t_gsw=9, t_conv=4, t_exp=8,
                  t_exp_right=8)


def dryrun_pipeline(n_devices: int, device="cuda") -> None:
    """The full Spiral pipeline (expansion, composition, conversion,
    row-sharded first dim, fold, modulus switch) over a ("db", "rep") mesh
    of the first n_devices ranks at dryrun_params, with a decode check.
    The rows shard over the power-of-two part of n_devices; any co-factor
    replicates.  It runs in the caller's world (a world of one without
    one); every rank of the world takes part in making the mesh, and
    those in it serve."""
    from torch.distributed.device_mesh import DeviceMesh
    from .pir import SpiralClient, SpiralServer
    from .server.db import encode_db, random_db

    db_axis = n_devices & -n_devices
    params = dryrun_params(n_devices)
    dev = torch.device(device)
    with multihost.world(dev):
        if dist.get_world_size() < n_devices:
            raise ValueError(f"a dry run over {n_devices} ranks in a world "
                             f"of {dist.get_world_size()}")
        mesh = DeviceMesh(dev.type,
                          torch.arange(n_devices).reshape(
                              db_axis, n_devices // db_axis),
                          mesh_dim_names=("db", "rep"))
        if dist.get_rank() >= n_devices:
            return
        rng = np.random.default_rng(0)
        idx = int(rng.integers(0, params.total_n))
        client = SpiralClient(params, seed=0, device=dev)
        pub = client.setup()
        pts = random_db(params, rng)
        server = SpiralServer(params, encode_db(pts, params, dev), pub,
                              mesh=mesh)
        resp, _ = server.process_query_fused(client.query(idx))
        if not np.array_equal(client.decode(resp), pts[idx].astype(object)):
            raise RuntimeError("sharded pipeline decode mismatch")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """dryrun_pipeline, then on the card check_kernels at its parameters
    (the JAX dry run's interpret-mode check of its Pallas kernels); on the
    CPU the plain versions are all that runs."""
    dryrun_pipeline(n_devices, device)
    if torch.device(device).type == "cuda":
        check_kernels(dryrun_params(n_devices))


def check_kernels(params: Params) -> None:
    """K3 (2 fold rounds of 4 cts) and K4 (2 expansion rounds, with K8a and
    K1) on the card, equal to the plain versions on the same inputs."""
    from .server.expand import coefficient_expansion
    from .server.fold import fold_rounds

    p, d = params, params.poly_len
    rng = np.random.default_rng(1)

    def both(*shapes):
        xs = [_residues(rng, s, -2, "cpu") for s in shapes]
        return xs, [x.cuda() for x in xs]

    cpu, gpu = both((4, p.n1, p.n2, 2, d), (2, p.n1, p.m2, 2, d),
                    (2, p.n1, p.m2, 2, d))
    got, want = (fold_rounds(x[0], ntt.forward(x[1]), ntt.forward(x[2]), p,
                             num_rounds=2) for x in (gpu, cpu))
    if not torch.equal(got.cpu(), want):
        raise RuntimeError("fold kernel (K3) differs from its plain version")
    g = 2
    cpu, gpu = both((1, 2, 1, 2, d), *[(2, p.m_exp, 2, d)] * g,
                    *[(2, p.m_exp_right, 2, d)] * g)
    got, want = (ntt.inverse(coefficient_expansion(
        ntt.forward(x[0]), g, [ntt.forward(w) for w in x[1:1 + g]],
        [ntt.forward(w) for w in x[1 + g:]], p)) for x in (gpu, cpu))
    if not torch.equal(got.cpu(), want):
        raise RuntimeError("expansion kernels (K4, K8a) differ from their "
                           "plain versions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    fn(*example).cpu()
    print("entry ok")
    with multihost.world(args.device):
        dryrun_multichip(dist.get_world_size(), args.device)
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
