"""Lossy int8 block quantization: per-4096-element amax scales.

The same scheme as ``optim/grad_compress`` but applied to egress datasets:
each block of 4096 consecutive elements is scaled by ``amax/127`` and
rounded to int8, shrinking float64 payloads 8x (float32 4x) minus a 4-byte
scale per block.  The reconstruction error is bounded: ``|x - dq| <=
scale/2`` per element, plus the float rounding of ``x/scale`` and of
``q*scale`` (rint is within 1/2 of ``x/scale`` and ``|x/scale| <= 127``, so
the clip never bites) — as long as the scale is a normal float. A block
whose amax is below ``127 * 2**-126`` gets a subnormal scale with few
significant bits; ``|x/scale|`` may then pass 127 and clip, and the error
is bounded by the block's amax instead.

A numpy bfloat16 (the port holds its bits as uint16, repro_torch.tensors)
is not a float to numpy, so it passes through, as the reference's numpy
bfloat16 (kind "V") does. A bfloat16 *tensor* is quantized, and decodes to
bfloat16 by rounding the float32 dequantized values to nearest even.

For a torch tensor (float32, float16 or bfloat16) the quantize+pack step
runs through the ``kernels/staging_pack`` quantizing variant
(``ops.quantize_blocks``): on a CUDA tensor the hand-written kernel, so
bytes shrink *on the card* before the host copy; on a CPU tensor its plain
version. numpy inputs, and float64 tensors (which the reference's device
path never sees), take an equivalent host path; every path emits the same
bytes.  Non-float dtypes pass through unchanged
(``meta["passthrough"]``) — lossy quantization of index data would be
silent corruption.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tensors import BF16, dtype_name, f32_to_bf16, to_host

from .base import Codec, as_bytes_array, np_dtype, register_codec

BLOCK = 4096  # elements per scale block; matches grad_compress.QBLOCK


@register_codec("int8-block")
class Int8BlockCodec(Codec):
    """Per-block int8 quantization; payload = f32 scales || int8 values.

    A torch tensor takes the staging_pack path (the kernel on the card);
    host numpy inputs take the vectorized numpy path.
    """

    lossless = False
    chained = False
    # encode() takes a torch tensor where it lies: the sender need not copy
    # it to the host first
    takes_tensors = True

    def encode(self, data, *, dtype: str = "uint8",
               key: str = "") -> Tuple[Any, Dict[str, Any]]:
        if isinstance(data, torch.Tensor):
            return self._encode_tensor(data, dtype=dtype, key=key)
        if isinstance(data, np.ndarray) and data.dtype != np.uint8:
            arr = np.ascontiguousarray(data)
        else:
            # bytes-like input (or a flat uint8 view, which is how the
            # Communicator ships every dataset): reinterpret through the
            # declared dataset dtype
            dt = np_dtype(dtype)
            raw = as_bytes_array(data)
            if dt is None or dt.itemsize == 0 or raw.size % dt.itemsize:
                return self._passthrough(raw)
            arr = raw.view(dt)
        if arr.dtype.kind != "f" or arr.dtype.itemsize < 2:
            return self._passthrough(as_bytes_array(arr))
        x = arr.reshape(-1)
        n = x.size
        nb = -(-n // BLOCK)
        scales = np.ones(nb, np.float32)
        q = np.empty(nb * BLOCK, np.int8)
        if n:
            # float16 math would wreck the scale/2 bound; compute in >=f32.
            cdt = x.dtype if x.dtype.itemsize >= 4 else np.dtype(np.float32)
            xb = np.zeros(nb * BLOCK, cdt)
            xb[:n] = x
            xb = xb.reshape(nb, BLOCK)
            amax = np.max(np.abs(xb), axis=1)
            scales = (amax / np.float32(127.0)).astype(np.float32)
            scales[scales == 0] = 1.0
            q = np.clip(np.rint(xb / scales[:, None].astype(cdt)),
                        -127, 127).astype(np.int8).reshape(-1)
        payload = scales.tobytes() + q[:n].tobytes()
        meta = {"raw_size": int(n * arr.dtype.itemsize), "n": int(n),
                "dtype": arr.dtype.name, "block": BLOCK}
        return payload, meta

    def _encode_tensor(self, x: torch.Tensor, *, dtype: str,
                       key: str) -> Tuple[Any, Dict[str, Any]]:
        """The reference's ``_encode_device`` on a torch tensor: quantize
        where the tensor lies, then copy only int8[:n] and the scales to
        the host, straight into the payload."""
        if not x.is_floating_point() or x.element_size() < 2 or \
                x.dtype == torch.float64:
            return self.encode(to_host(x), dtype=dtype, key=key)
        from repro_torch.kernels.staging_pack import ops
        q, scales = ops.quantize_blocks(x.detach(), block_elems=BLOCK)
        n = x.numel()
        nb = scales.numel()
        host = torch.empty(nb * 4 + n, dtype=torch.uint8,
                           pin_memory=x.device.type == "cuda")
        host[:nb * 4].copy_(scales.view(torch.uint8))
        host[nb * 4:].copy_(q.view(torch.uint8).reshape(-1)[:n])
        meta = {"raw_size": int(n * x.element_size()), "n": int(n),
                "dtype": dtype_name(x), "block": BLOCK}
        return host.numpy(), meta

    @staticmethod
    def _passthrough(raw: np.ndarray) -> Tuple[Any, Dict[str, Any]]:
        return raw, {"raw_size": int(raw.size), "passthrough": True}

    def decode(self, payload, meta: Dict[str, Any], *,
               key: str = "") -> np.ndarray:
        raw = as_bytes_array(payload)
        if meta.get("passthrough"):
            return raw
        n = int(meta["n"])
        block = int(meta.get("block", BLOCK))
        bf16 = meta["dtype"] == BF16
        dt = np.dtype(np.float32) if bf16 else np.dtype(meta["dtype"])
        nb = -(-n // block)
        if raw.size != nb * 4 + n:
            raise ValueError(
                f"int8-block payload is {raw.size}B, expected "
                f"{nb * 4 + n}B ({nb} scales + {n} values)")
        scales = raw[:nb * 4].view(np.float32)
        q = np.zeros(nb * block, np.int8)
        q[:n] = raw[nb * 4:].view(np.int8)
        cdt = dt if dt.itemsize >= 4 else np.dtype(np.float32)
        dq = (q.reshape(nb, block).astype(cdt) *
              scales[:, None].astype(cdt)).reshape(-1)[:n]
        out = f32_to_bf16(dq) if bf16 else dq.astype(dt)
        return np.ascontiguousarray(out).view(np.uint8)
