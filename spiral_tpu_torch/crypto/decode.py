"""Response modulus switch on the server's device (counterpart of
spiral_tpu/crypto/decode.py modswitch_device).  The host-side Response
container and decode_response are the JAX package's own: they import no
jax."""
from __future__ import annotations

import torch

from spiral_tpu.crypto.decode import Response, decode_response  # noqa: F401
from spiral_tpu.params import Params
from ..core.rescale import rescale_residues_device


def modswitch_device(final: torch.Tensor, params: Params):
    """final (rows, cols, 2, d) residues -> (row 0 rescaled to q', rows 1..
    rescaled to 4p) int32 tensors."""
    first = rescale_residues_device(final[:1, :, 0], final[:1, :, 1],
                                    params.arb_qprime)
    rest = rescale_residues_device(final[1:, :, 0], final[1:, :, 1],
                                   4 * params.p_db)
    return first, rest


def response_from_device_rows(first, rest) -> Response:
    return Response(first_row=first.cpu().numpy().astype(object),
                    rest_rows=rest.cpu().numpy().astype(object))
