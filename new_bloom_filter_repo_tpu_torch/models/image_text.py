"""Standalone binary / image / text Bloom codec.

The PyTorch port of ``new_bloom_filter_repo_tpu.models.image_text``:
binarization of images (grayscale > threshold) and text (bit-unpacked
bytes), the binary codec of ``models/binary_codec.py`` with the
``"compress"`` hash seeds (h1=0, h2=1, activation 999), and the
network-byte-order ('!') serialization formats for images and text.
PIL is imported only by :meth:`BloomCompressor.compress_image` and
:meth:`BloomCompressor.decompress_image` (with an output path).
"""

from __future__ import annotations

import io
import struct
from typing import Optional, Tuple

import numpy as np

from new_bloom_filter_repo_tpu_torch.models.binary_codec import (
    BloomFilterCompressor as _DeviceCodec,
)
from new_bloom_filter_repo_tpu_torch.models.bloom import (
    P_STAR,
    optimal_compression_params,
)


class BloomCompressor:
    """The standalone codec surface; ``device`` runs the Bloom passes
    (default: the current CUDA card; without a card, pass
    ``device="cpu"``, or the constructor raises)."""

    P_STAR = P_STAR

    def __init__(self, device=None):
        self._codec = _DeviceCodec(seed_set="compress", device=device)

    # -- core binary codec ---------------------------------------------
    @staticmethod
    def _calculate_optimal_params(n: int, p: float) -> Tuple[float, int]:
        return optimal_compression_params(n, p)

    def compress(self, binary_input):
        return self._codec.compress(binary_input)

    def decompress(self, bloom_bitmap, witness, n, k):
        return self._codec.decompress(bloom_bitmap, witness, n, k)

    # -- binarization ----------------------------------------------------
    @staticmethod
    def _binarize_image(image: np.ndarray, threshold: int = 127) -> np.ndarray:
        image = np.asarray(image)
        if image.ndim > 2 and image.shape[2] > 1:
            image = np.mean(image, axis=2).astype(np.uint8)
        return (image > threshold).astype(np.uint8).ravel()

    @staticmethod
    def _binarize_text(text: str, bit_depth: int = 8) -> np.ndarray:
        if bit_depth == 8:
            data = text.encode("ascii", errors="replace")
        else:
            data = text.encode("utf-8")
        return np.unpackbits(np.frombuffer(data, dtype=np.uint8))

    @staticmethod
    def _debinarize_text(binary_array: np.ndarray, bit_depth: int = 8) -> str:
        pad = (-len(binary_array)) % 8
        if pad:
            binary_array = np.pad(binary_array, (0, pad))
        data = np.packbits(binary_array).tobytes()
        if bit_depth == 8:
            return data.decode("ascii", errors="replace")
        return data.decode("utf-8", errors="replace")

    # -- image front-end -------------------------------------------------
    def compress_image(self, image_path: str, threshold: int = 127,
                       output_path: Optional[str] = None):
        from PIL import Image
        img = np.array(Image.open(image_path))
        binary = self._binarize_image(img, threshold)
        bitmap, witness, p, n, ratio = self.compress(binary)
        k, _ = self._calculate_optimal_params(n, p)
        data = self._pack_compressed_data(bitmap, witness, p, n, k,
                                          img.shape)
        if output_path:
            with open(output_path, "wb") as f:
                f.write(data)
        return data, ratio

    def decompress_image(self, compressed_data: bytes,
                         output_path: Optional[str] = None) -> np.ndarray:
        bitmap, witness, p, n, k, shape = self._unpack_compressed_data(
            compressed_data)
        binary = self.decompress(bitmap, witness, n, k)
        h, w = shape[:2]
        img = (binary.reshape(h, w) * 255).astype(np.uint8)
        if output_path:
            from PIL import Image
            Image.fromarray(img).save(output_path)
        return img

    # -- text front-end --------------------------------------------------
    def compress_text(self, text: str, bit_depth: int = 8,
                      output_path: Optional[str] = None):
        binary = self._binarize_text(text, bit_depth)
        bitmap, witness, p, n, ratio = self.compress(binary)
        k, _ = self._calculate_optimal_params(n, p)
        data = self._pack_text_data(bitmap, witness, p, n, k,
                                    len(text), bit_depth)
        if output_path:
            with open(output_path, "wb") as f:
                f.write(data)
        return data, ratio

    def decompress_text(self, compressed_data: bytes,
                        output_path: Optional[str] = None) -> str:
        (bitmap, witness, p, n, k, text_len,
         bit_depth) = self._unpack_text_data(compressed_data)
        binary = self.decompress(bitmap, witness, n, k)
        text = self._debinarize_text(binary, bit_depth)[:text_len]
        if output_path:
            with open(output_path, "w", encoding="utf-8") as f:
                f.write(text)
        return text

    # -- '!'-packed formats ----------------------------------------------
    @staticmethod
    def _pack_compressed_data(bitmap, witness, p, n, k, shape) -> bytes:
        buf = io.BytesIO()
        buf.write(struct.pack("!f", p))
        buf.write(struct.pack("!I", n))
        buf.write(struct.pack("!f", k))
        buf.write(struct.pack("!B", len(shape)))
        for dim in shape:
            buf.write(struct.pack("!I", dim))
        buf.write(struct.pack("!I", len(bitmap)))
        buf.write(struct.pack("!I", len(witness)))
        buf.write(np.packbits(np.asarray(bitmap, np.uint8)).tobytes())
        buf.write(np.packbits(np.asarray(witness, np.uint8)).tobytes())
        return buf.getvalue()

    @staticmethod
    def _unpack_compressed_data(data: bytes):
        buf = io.BytesIO(data)
        p = struct.unpack("!f", buf.read(4))[0]
        n = struct.unpack("!I", buf.read(4))[0]
        k = struct.unpack("!f", buf.read(4))[0]
        ndim = struct.unpack("!B", buf.read(1))[0]
        shape = tuple(struct.unpack("!I", buf.read(4))[0]
                      for _ in range(ndim))
        l = struct.unpack("!I", buf.read(4))[0]
        wlen = struct.unpack("!I", buf.read(4))[0]
        bitmap = np.unpackbits(np.frombuffer(
            buf.read((l + 7) // 8), dtype=np.uint8))[:l]
        witness = np.unpackbits(np.frombuffer(
            buf.read((wlen + 7) // 8), dtype=np.uint8))[:wlen]
        return bitmap, witness, p, n, k, shape

    @staticmethod
    def _pack_text_data(bitmap, witness, p, n, k, text_len,
                        bit_depth) -> bytes:
        buf = io.BytesIO()
        buf.write(struct.pack("!f", p))
        buf.write(struct.pack("!I", n))
        buf.write(struct.pack("!f", k))
        buf.write(struct.pack("!I", text_len))
        buf.write(struct.pack("!B", bit_depth))
        buf.write(struct.pack("!I", len(bitmap)))
        buf.write(struct.pack("!I", len(witness)))
        buf.write(np.packbits(np.asarray(bitmap, np.uint8)).tobytes())
        buf.write(np.packbits(np.asarray(witness, np.uint8)).tobytes())
        return buf.getvalue()

    @staticmethod
    def _unpack_text_data(data: bytes):
        buf = io.BytesIO(data)
        p = struct.unpack("!f", buf.read(4))[0]
        n = struct.unpack("!I", buf.read(4))[0]
        k = struct.unpack("!f", buf.read(4))[0]
        text_len = struct.unpack("!I", buf.read(4))[0]
        bit_depth = struct.unpack("!B", buf.read(1))[0]
        l = struct.unpack("!I", buf.read(4))[0]
        wlen = struct.unpack("!I", buf.read(4))[0]
        bitmap = np.unpackbits(np.frombuffer(
            buf.read((l + 7) // 8), dtype=np.uint8))[:l]
        witness = np.unpackbits(np.frombuffer(
            buf.read((wlen + 7) // 8), dtype=np.uint8))[:wlen]
        return bitmap, witness, p, n, k, text_len, bit_depth
