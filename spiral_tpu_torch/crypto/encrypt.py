"""Encryption (counterpart of spiral_tpu/crypto/encrypt.py).  Ciphertexts
are residue tensors (rows, cols, 2, d); a scalar Regev ct is (-a; a*sr + e)
and a matrix ct under S = [Sp | I] is [-A; Sp*A + E] + [0; M]."""
from __future__ import annotations

import torch

from ..arith import ntt
from ..arith.crt import residues_from_values
from ..core.poly import add_raw, matmul_raw, neg_raw, scalar_mul_raw
from ..core.sampling import gaussian_values, uniform_residues
from .keys import SecretKeys


class Encryptor:
    def __init__(self, keys: SecretKeys, d: int, gen: torch.Generator,
                 nonoise: bool = False):
        self.keys, self.d, self.gen, self.nonoise = keys, d, gen, nonoise
        self.device = keys.sr.device

    def noise(self, rows: int, cols: int) -> torch.Tensor:
        """Gaussian error (rows, cols, 2, d), coefficient domain."""
        if self.nonoise:
            v = torch.zeros((rows, cols, self.d), dtype=torch.int64)
        else:
            v = gaussian_values(self.gen, (rows, cols, self.d))
        return residues_from_values(v).to(self.device)

    def uniform(self, rows: int, cols: int) -> torch.Tensor:
        return uniform_residues(self.gen, (rows, cols, self.d)).to(self.device)

    def fresh_public_key_raw(self, m: int) -> torch.Tensor:
        """[-A; Sp*A + E], (k + n) x m, coefficient domain."""
        Sp = self.keys.Sp
        A = self.uniform(Sp.shape[1], m)
        B = add_raw(matmul_raw(ntt.forward(Sp), ntt.forward(A)),
                    ntt.forward(self.noise(Sp.shape[0], m)))
        return torch.cat([neg_raw(A), ntt.inverse(B)], dim=0)

    def encrypt_matrix(self, M_ntt: torch.Tensor) -> torch.Tensor:
        """Enc_S(M) = P + [0; M], NTT domain; M is n x m."""
        P = ntt.forward(self.fresh_public_key_raw(M_ntt.shape[1]))
        k = self.keys.Sp.shape[1]
        return torch.cat([P[:k], add_raw(P[k:], M_ntt)], dim=0)

    def encrypt_simple_regev_matrix(self, M_ntt: torch.Tensor) -> torch.Tensor:
        """Row-vector message (1, m) under sr: (2, m, 2, d), NTT domain."""
        m = M_ntt.shape[1]
        a = self.uniform(1, m)
        b = add_raw(scalar_mul_raw(ntt.forward(self.keys.sr)[0, 0],
                                   ntt.forward(a)),
                    ntt.forward(self.noise(1, m)))
        return torch.cat([ntt.forward(neg_raw(a)), add_raw(b, M_ntt)], dim=0)
