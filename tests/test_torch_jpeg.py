"""The port's JPEG codec against cv2 (libjpeg): the decoder equals
``cv2.imread`` bit for bit on the kinds of JPEG it reads, refuses the kinds
it does not read by name, and the encoder writes files that cv2 and the
port decode to the same pixels."""

import io
import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from piccolo_tpu_torch.harness import imaging

torch.set_num_threads(1)

S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
WRITES = {
    "q95_420": [cv2.IMWRITE_JPEG_QUALITY, 95],
    "q60": [cv2.IMWRITE_JPEG_QUALITY, 60],
    "444": [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "422": [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "440": [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440],
    "411": [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411],
    "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
}
SIZES = [(64, 96), (37, 53), (1, 1), (2, 2), (3, 5), (17, 4)]


def _scene(h, w, seed=0):
    """Smooth colour gradients with pixel noise: both low and high
    frequencies survive the DCT."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 13.0),
                    128 + 90 * np.cos(y / 5.0), (x * 3 + y * 2) % 256], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


def _cv2_pixels(data: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", sorted(WRITES))
def test_decoder_equals_cv2_imread(kind, size, tmp_path):
    img = _scene(*size)
    path = str(tmp_path / "a.jpg")
    assert cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR), WRITES[kind])
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    got = imaging.imread_rgb(path)
    assert got.dtype == np.uint8 and got.shape == size + (3,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(64, 96), (37, 53), (1, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_grey_decodes_to_three_equal_channels(size, tmp_path):
    path = str(tmp_path / "g.jpg")
    cv2.imwrite(path, _scene(*size)[..., 1])
    got = imaging.imread_rgb(path)
    np.testing.assert_array_equal(got, cv2.cvtColor(cv2.imread(path),
                                                    cv2.COLOR_BGR2RGB))
    assert (got == got[..., :1]).all()


@pytest.mark.parametrize("size", [(64, 96), (37, 53)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pil_q75_file(size):
    buf = io.BytesIO()
    Image.fromarray(_scene(*size, seed=3)).save(buf, "JPEG", quality=75)
    data = buf.getvalue()
    np.testing.assert_array_equal(imaging.jpeg_decode(data), _cv2_pixels(data))


def test_a_large_frame(tmp_path):
    """A 1024x2048 frame, the shape of the panoramas the harness reads
    after its resize, through the file path."""
    y, x = np.mgrid[:1024, :2048]
    img = np.clip(np.stack([128 + 100 * np.sin(x / 37.0 + y / 53.0),
                            128 + 90 * np.cos(y / 25.0), (x * 3 + y * 2) % 256],
                           -1), 0, 255).astype(np.uint8)
    path = str(tmp_path / "big.jpg")
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(
        imaging.imread_rgb(path), cv2.cvtColor(cv2.imread(path),
                                               cv2.COLOR_BGR2RGB))


@pytest.mark.parametrize("size", [(64, 96), (37, 53), (1, 1), (3, 5)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [95, 60])
def test_encoder_bytes_decode_alike(size, quality, tmp_path):
    """The port's JPEG is valid: cv2.imdecode and the port read the same
    pixels from it, through bytes and through a file."""
    img = _scene(*size, seed=5)
    data = imaging.jpeg_encode(img, quality)
    got = imaging.jpeg_decode(data)
    np.testing.assert_array_equal(got, _cv2_pixels(data))
    if quality == 95:  # imwrite_rgb's quality
        path = str(tmp_path / "w.jpg")
        imaging.imwrite_rgb(path, img)
        np.testing.assert_array_equal(imaging.imread_rgb(path), got)
    if size == (64, 96) and quality == 95:
        ok, ref = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        # cv2's own q95 4:2:0 file of the same image decodes to the same
        # pixels: the same tables, DCT and rounding
        np.testing.assert_array_equal(got, _cv2_pixels(ref.tobytes()))


def _with_segment(data: bytes, marker: int, body: bytes) -> bytes:
    """``data`` with one more marker segment right after SOI."""
    return data[:2] + struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body + data[2:]


def _exif(orientation: int) -> bytes:
    ifd = struct.pack("<H", 1) + struct.pack("<HHIHH", 0x0112, 3, 1,
                                             orientation, 0) + b"\0\0\0\0"
    return b"Exif\0\0" + b"II*\0" + struct.pack("<I", 8) + ifd


def _sof_patched(data: bytes, marker=None, precision=None, ncomp=None,
                 ids=None, tq0=None):
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if tq0 is not None:  # the first component's quantisation table slot
        out[i + 12] = tq0
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    if ncomp is not None:
        out[i + 9] = ncomp
    if ids is not None:  # component ids, in the frame header and the scan
        for k, new in enumerate(ids):
            out[i + 10 + 3 * k] = new
        j = data.index(b"\xff\xda")
        for k, new in enumerate(ids):
            out[j + 5 + 2 * k] = new
    return bytes(out)


def _without_jfif(data: bytes) -> bytes:
    i = data.index(b"\xff\xe0")
    (n,) = struct.unpack(">H", data[i + 2:i + 4])
    return data[:i] + data[i + 2 + n:]


def test_refusals_name_the_kind():
    img = _scene(32, 32)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    base = cv2.imencode(".jpg", img)[1].tobytes()
    cases = [
        (prog.tobytes(), "progressive"),
        (_sof_patched(base, marker=0xC9), "arithmetic-coded"),
        (_sof_patched(base, marker=0xC3), "lossless"),
        (_sof_patched(base, precision=12), "12-bit"),
        (_sof_patched(base, ncomp=4), "CMYK"),
        (_without_jfif(_sof_patched(base, ids=b"RGB")), "RGB-coded"),
        (_with_segment(base, 0xE1, _exif(6)), "EXIF orientation 6"),
        (b"\x89PNG\r\n\x1a\n", "not a JPEG"),
        (_sof_patched(base, tq0=7), "corrupt"),
    ]
    for data, match in cases:
        with pytest.raises(ValueError, match=match):
            imaging.jpeg_decode(data)
    # orientation 1 is the identity, and decodes
    np.testing.assert_array_equal(
        imaging.jpeg_decode(_with_segment(base, 0xE1, _exif(1))),
        _cv2_pixels(base))


def test_decode_in_two_threads():
    """The prefetch thread decodes beside the main thread: two decodes in
    two threads at once give the same pixels."""
    import threading

    data = imaging.jpeg_encode(_scene(256, 512))
    out = [None, None]

    def run(i):
        out[i] = imaging.jpeg_decode(data)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    np.testing.assert_array_equal(out[0], out[1])
