"""The training sets' file formats in the port, against the JAX package and
OpenCV: 16-bit PNG (``nsof_tpu_torch/utils/png.py``: KITTI and HD1K flow),
binary PPM (``nsof_tpu_torch/utils/ppm.py``: FlyingChairs frames), and
``.flo`` / ``.pfm`` (``nsof_tpu_torch/data/flow_datasets.py``).

- A KITTI flow file written by the JAX ``write_kitti_flow`` (OpenCV) reads
  back bit-equal through the port, and the port's file bit-equal through
  the JAX ``read_kitti_flow``; the port's 16-bit decode equals
  ``cv2.imread(..., IMREAD_ANYDEPTH | IMREAD_COLOR)`` (in RGB order) on
  16-bit RGB and RGBA files, every row filter included.
- A ``.ppm`` written by ``cv2.imwrite`` reads equal to ``cv2.imread`` (RGB
  order), a header with comments too; the port's writer reads back through
  OpenCV.
- ``.flo`` and ``.pfm`` (colour and gray, both byte orders) bit-equal both
  ways.
- 16-bit gray, sub-byte and 16-bit PPM images raise ``ValueError``.
"""

import struct
import zlib

import numpy as np
import pytest

from nsof_tpu.data import flow_datasets as jfd
from nsof_tpu_torch.data import flow_datasets as tfd
from nsof_tpu_torch.utils.png import SIGNATURE, decode_png, decode_png16, encode_png16
from nsof_tpu_torch.utils.ppm import decode_ppm, encode_ppm

cv2 = pytest.importorskip("cv2")

RNG = np.random.default_rng(0)


def _flow(h=21, w=34):
    flow = (RNG.normal(size=(h, w, 2)) * 30).astype(np.float32)
    valid = RNG.random((h, w)) > 0.3
    return flow, valid


def test_kitti_flow_jax_written_reads_bit_equal(tmp_path):
    flow, valid = _flow()
    jfd.write_kitti_flow(tmp_path / "j.png", flow, valid)
    got, want = tfd.read_kitti_flow(tmp_path / "j.png"), jfd.read_kitti_flow(tmp_path / "j.png")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.float32 and got[1].dtype == bool


@pytest.mark.parametrize("with_valid", [True, False])
def test_kitti_flow_port_written_reads_bit_equal_in_jax(tmp_path, with_valid):
    flow, valid = _flow(17, 40)
    flow[0, 0] = [600.0, -600.0]  # clipped to the 16-bit range by both writers
    tfd.write_kitti_flow(tmp_path / "t.png", flow, valid if with_valid else None)
    jfd.write_kitti_flow(tmp_path / "j.png", flow, valid if with_valid else None)
    got = jfd.read_kitti_flow(tmp_path / "t.png")
    want = jfd.read_kitti_flow(tmp_path / "j.png")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    ref = cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(decode_png16((tmp_path / "t.png").read_bytes()),
                                  ref[..., ::-1])


def _png16(w, h, ctype, img, kinds):
    """A 16-bit PNG whose rows use the filter types ``kinds`` (raw bytes,
    filtered by the specification's per-byte definitions)."""
    bpp = {2: 6, 6: 8}[ctype]
    lines = np.ascontiguousarray(img.astype(">u2")).view(np.uint8).reshape(h, -1).astype(np.int64)
    out = np.empty_like(lines)
    for y in range(h):
        prior = lines[y - 1] if y else np.zeros_like(lines[0])
        for i in range(lines.shape[1]):
            a = lines[y, i - bpp] if i >= bpp else 0
            b, c = prior[i], (prior[i - bpp] if i >= bpp else 0)
            p = a + b - c
            pred = [0, a, b, (a + b) // 2,
                    a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c)
                    else (b if abs(p - b) <= abs(p - c) else c)][kinds[y]]
            out[y, i] = (lines[y, i] - pred) % 256
    raw = np.concatenate([np.asarray(kinds, np.uint8)[:, None], out.astype(np.uint8)], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, h, 16, ctype, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_png16_every_row_filter_against_cv2(tmp_path, channels):
    h, w = 10, 7
    img = RNG.integers(0, 2 ** 16, (h, w, channels)).astype(np.uint16)
    data = _png16(w, h, {3: 2, 4: 6}[channels], img, [y % 5 for y in range(h)])
    (tmp_path / "a.png").write_bytes(data)
    ref = cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(decode_png16(data), ref[..., ::-1])
    np.testing.assert_array_equal(decode_png16(data), img[..., :3])
    np.testing.assert_array_equal(decode_png16(encode_png16(img[..., :3])), img[..., :3])


def test_ppm_against_cv2(tmp_path):
    img = RNG.integers(0, 256, (23, 31, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.ppm"), img)  # BGR in memory, RGB in the file
    np.testing.assert_array_equal(decode_ppm((tmp_path / "a.ppm").read_bytes()),
                                  cv2.imread(str(tmp_path / "a.ppm"))[..., ::-1])
    np.testing.assert_array_equal(tfd.read_image(tmp_path / "a.ppm"), img[..., ::-1])
    (tmp_path / "b.ppm").write_bytes(encode_ppm(img))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "b.ppm"))[..., ::-1], img)
    commented = b"P6\n# made by hand\n31 23\n# max\n255\n" + img.tobytes()
    np.testing.assert_array_equal(decode_ppm(commented), img)


def test_rejects_what_it_cannot_read():
    gray16 = _png16(4, 2, 2, np.zeros((2, 4, 3), np.uint16), [0, 0])
    gray16 = gray16.replace(struct.pack(">IIBBBBB", 4, 2, 16, 2, 0, 0, 0),
                            struct.pack(">IIBBBBB", 4, 2, 16, 0, 0, 0, 0))
    with pytest.raises(ValueError, match="16-bit"):
        decode_png(encode_png16(np.zeros((2, 4, 3), np.uint16)))
    with pytest.raises(ValueError):
        decode_png16(gray16)
    ihdr4 = struct.pack(">IIBBBBB", 4, 2, 4, 0, 0, 0, 0)
    sub_byte = gray16.replace(struct.pack(">IIBBBBB", 4, 2, 16, 0, 0, 0, 0), ihdr4)
    for fn in (decode_png, decode_png16):
        with pytest.raises(ValueError):
            fn(sub_byte)
    with pytest.raises(ValueError, match="8-bit"):
        decode_ppm(b"P6\n2 2\n65535\n" + bytes(24))
    with pytest.raises(ValueError, match="P6"):
        decode_ppm(b"P5\n2 2\n255\n" + bytes(4))
    with pytest.raises(ValueError, match="shorter"):
        decode_ppm(b"P6\n2 2\n255\n" + bytes(5))


def test_flo_and_pfm_bit_equal(tmp_path):
    flow = RNG.normal(size=(13, 19, 2)).astype(np.float32)
    jfd.write_flo(tmp_path / "j.flo", flow)
    tfd.write_flo(tmp_path / "t.flo", flow)
    assert (tmp_path / "j.flo").read_bytes() == (tmp_path / "t.flo").read_bytes()
    np.testing.assert_array_equal(tfd.read_flo(tmp_path / "j.flo"),
                                  jfd.read_flo(tmp_path / "j.flo"))
    for kind, shape in ((b"PF", (9, 11, 3)), (b"Pf", (9, 11))):
        for order, scale in (("<f4", b"-1.0"), (">f4", b"1.0")):
            data = RNG.normal(size=shape).astype(order)
            path = tmp_path / f"{kind.decode()}{order[0] == '<'}.pfm"
            path.write_bytes(kind + b"\n11 9\n" + scale + b"\n" + data.tobytes())
            np.testing.assert_array_equal(tfd.read_pfm(path), jfd.read_pfm(path))
            if kind == b"PF":
                got, want = tfd.read_flow_any(path), jfd.read_flow_any(path)
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1] is None and want[1] is None
