"""The port's JPEG reader (photo_slam_tpu_torch/io/jpeg.py, host C++ in
csrc_host/jpeg.cpp) against cv2.imread, which decodes with libjpeg-turbo.

Files written by cv2 (quality 95 and 75; 4:4:4, 4:2:2 and 4:2:0; gray;
restart intervals) and by PIL with optimize=True (custom Huffman tables) are
read with the loaders' cv2 and PIL hidden, as on the machine with the card,
and must equal cv2.imread pixel for pixel: the reader computes
libjpeg-turbo's ISLOW IDCT, fancy upsampling and fixed-point colour
conversion. The kinds it refuses raise with the kind named. A Replica
sequence of JPEG frames loads as it does through cv2, and synth_replica
writes PNG frames where no JPEG encoder imports."""
import hashlib

import numpy as np
import pytest

from photo_slam_tpu_torch import native
from photo_slam_tpu_torch.io import images, jpeg
from photo_slam_tpu_torch.io.datasets import REPLICA_DEPTH_SCALE, ReplicaDataset
from photo_slam_tpu_torch.tools import synth_replica
from test_torch_blend import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")
PIL_Image = pytest.importorskip("PIL.Image")

import chip_smoke  # noqa: E402

FIXTURE = synth_replica.PHOTO.with_suffix(".jpg")
S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


@pytest.fixture
def no_image_library(monkeypatch):
    """The loaders as on a machine without cv2 and PIL."""
    monkeypatch.setattr(images, "cv2", None)
    monkeypatch.setattr(images, "Image", None)


def photo_bgr(h=237, w=301):
    """A crop of the photograph at sizes that are not multiples of the MCU."""
    return np.ascontiguousarray(cv2.imread(str(synth_replica.PHOTO))[:h, :w])


def cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def cv2_chw(path):
    return np.transpose(cv2_rgb(path).astype(np.float32) / 255.0, (2, 0, 1))


@pytest.mark.parametrize("quality", [95, 75])
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("restart", [0, 3])
def test_cv2_files_decode_like_cv2(tmp_path, quality, sampling, restart,
                                   no_image_library):
    path = tmp_path / "f.jpg"
    cv2.imwrite(str(path), photo_bgr(),
                [cv2.IMWRITE_JPEG_QUALITY, quality, S, SAMPLING[sampling],
                 cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert (path.read_bytes().count(b"\xff\xdd") == 1) == bool(restart)
    np.testing.assert_array_equal(jpeg.read_jpeg(path), cv2_rgb(path))
    np.testing.assert_array_equal(images.load_image_chw(path), cv2_chw(path))
    # The luma plane, as IMREAD_GRAYSCALE reads a colour file.
    np.testing.assert_array_equal(
        jpeg.read_jpeg(path, gray=True),
        cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("quality", [95, 75])
def test_gray_files_decode_like_cv2(tmp_path, quality, no_image_library):
    path = tmp_path / "g.jpg"
    cv2.imwrite(str(path), cv2.cvtColor(photo_bgr(), cv2.COLOR_BGR2GRAY),
                [cv2.IMWRITE_JPEG_QUALITY, quality])
    got = jpeg.read_jpeg(path)
    assert got.ndim == 2
    np.testing.assert_array_equal(got, cv2.imread(str(path),
                                                  cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(images.load_image_chw(path), cv2_chw(path))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_pil_optimized_files_decode_like_cv2(tmp_path, subsampling,
                                             no_image_library):
    """optimize=True writes Huffman tables made for the image."""
    path = tmp_path / "p.jpg"
    PIL_Image.fromarray(photo_bgr(200, 333)[..., ::-1]).save(
        path, "JPEG", quality=85, optimize=True, subsampling=subsampling)
    np.testing.assert_array_equal(jpeg.read_jpeg(path), cv2_rgb(path))


def test_noise_and_tiny_images_decode_like_cv2(tmp_path):
    rng = np.random.default_rng(0)
    for i, img in enumerate((rng.integers(0, 256, (67, 91, 3), np.uint8),
                             photo_bgr(9, 13), photo_bgr(1, 2))):
        for sampling in SAMPLING.values():
            path = tmp_path / f"n{i}.jpg"
            cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_QUALITY, 90, S,
                                         sampling])
            np.testing.assert_array_equal(jpeg.read_jpeg(path),
                                          cv2_rgb(path))


def test_fixture_hash_is_cv2s():
    """chip_smoke.py checks the fixture's decoded pixels against this
    constant on the card's machine (no cv2 there)."""
    rgb = cv2_rgb(FIXTURE)
    assert rgb.shape == (600, 512, 3)
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
        chip_smoke.JPEG_SHA256
    assert chip_smoke.jpeg_sha256(jpeg.read_jpeg(FIXTURE)) == \
        chip_smoke.JPEG_SHA256


def with_segment(data: bytes, marker: int, body: bytes) -> bytes:
    """JPEG bytes with a segment inserted right after SOI."""
    seg = bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body
    return data[:2] + seg + data[2:]


def exif_orientation(value: int) -> bytes:
    """An APP1 Exif body whose IFD0 holds the orientation tag."""
    tiff = (b"II*\x00" + (8).to_bytes(4, "little") + (1).to_bytes(2, "little")
            + (0x0112).to_bytes(2, "little") + (3).to_bytes(2, "little")
            + (1).to_bytes(4, "little") + value.to_bytes(2, "little")
            + b"\x00\x00" + (0).to_bytes(4, "little"))
    return b"Exif\x00\x00" + tiff


def patched_frame(data: bytes, sof: int = None, precision: int = None):
    """The baseline file with its SOF0 marker or precision byte changed."""
    at = data.index(b"\xff\xc0")
    out = bytearray(data)
    if sof is not None:
        out[at + 1] = sof
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("kind", ["progressive", "arithmetic", "lossless",
                                  "12-bit", "sampling", "orientation",
                                  "truncated", "cut header"])
def test_refused_kinds_raise_naming_the_kind(tmp_path, kind):
    base = cv2.imencode(".jpg", photo_bgr(), [cv2.IMWRITE_JPEG_QUALITY,
                                              90])[1].tobytes()
    data, match = {
        "progressive": (cv2.imencode(".jpg", photo_bgr(), [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes(), "progressive"),
        "arithmetic": (patched_frame(base, sof=0xC9), "arithmetic"),
        "lossless": (patched_frame(base, sof=0xC3), "lossless"),
        "12-bit": (patched_frame(base, precision=12), "12-bit"),
        "sampling": (cv2.imencode(".jpg", photo_bgr(), [
            S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])[1].tobytes(),
            "sampling factors"),
        "orientation": (with_segment(base, 0xE1, exif_orientation(6)),
                        "EXIF orientation 6"),
        "truncated": (base[:len(base) // 2], "truncated"),
        "cut header": (base[:300], "truncated"),
    }[kind]
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        jpeg.read_jpeg(path)
    if kind == "orientation":
        # The orientation the file stores is read as it is.
        path.write_bytes(with_segment(base, 0xE1, exif_orientation(1)))
        np.testing.assert_array_equal(jpeg.read_jpeg(path), cv2_rgb(path))


@pytest.mark.parametrize("counts", [
    {1: 3},            # three 1-bit codes
    {1: 255},          # a length's count past its whole code space
    {1: 2, 2: 1},      # a full length, then one code more
    {1: 1, 2: 1, 3: 3},
])
def test_overfull_huffman_table_raises(tmp_path, counts):
    """A DHT whose code lengths overrun the code space is refused before
    any of its codes are entered in the decoder's tables."""
    base = cv2.imencode(".jpg", photo_bgr(), [cv2.IMWRITE_JPEG_QUALITY,
                                              90])[1].tobytes()
    lengths = bytes(counts.get(l, 0) for l in range(1, 17))
    body = b"\x00" + lengths + bytes(range(sum(counts.values())))
    path = tmp_path / "x.jpg"
    path.write_bytes(with_segment(base, 0xC4, body))
    with pytest.raises(ValueError, match="bad Huffman table"):
        jpeg.read_jpeg(path)


def test_missing_file_and_unknown_kind(tmp_path, no_image_library):
    with pytest.raises(FileNotFoundError):
        jpeg.read_jpeg(tmp_path / "none.jpg")
    with pytest.raises(FileNotFoundError):
        images.load_image_chw(tmp_path / "none.jpg")
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")


def test_reader_builds_into_build_dir():
    jpeg.read_jpeg(FIXTURE)
    path = native.libraries()["jpeg"]
    assert path == native.library_path("jpeg") and path.exists()
    assert path.parent.parts[-2:] == ("build", "torch_native")


def write_replica(root, n=3, size=(120, 68)):
    """A Replica layout of JPEG frames (crops of the photograph), 16-bit
    depth PNGs and traj.txt."""
    results = root / "results"
    results.mkdir(parents=True)
    photo = cv2.imread(str(synth_replica.PHOTO))
    for i in range(n):
        crop = cv2.resize(photo[20 * i:20 * i + 400, 10 * i:10 * i + 500],
                          size)
        cv2.imwrite(str(results / f"frame{i:06d}.jpg"), crop,
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        depth = np.full(size[::-1], 1.5 + 0.1 * i)
        cv2.imwrite(str(results / f"depth{i:06d}.png"),
                    (depth * REPLICA_DEPTH_SCALE).astype(np.uint16))
    np.savetxt(root / "traj.txt", np.tile(np.eye(4).reshape(1, -1), (n, 1)))
    return root


def test_replica_jpeg_sequence_loads_without_a_library(tmp_path,
                                                       monkeypatch):
    root = write_replica(tmp_path / "seq")
    want = list(ReplicaDataset(root).frames())
    monkeypatch.setattr(images, "cv2", None)
    monkeypatch.setattr(images, "Image", None)
    ds = ReplicaDataset(root)
    got = list(ds.frames())
    assert len(got) == len(want) == 3 and ds.camera.width == 120
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.image, w.image)
        np.testing.assert_array_equal(g.depth, w.depth)


def test_synth_replica_writes_png_frames_without_an_encoder(tmp_path,
                                                            no_image_library):
    seq = synth_replica.SynthReplica(2, 64, 36, device="cpu", n_splats=2000)
    root = seq.write(tmp_path / "seq")
    frames = sorted(p.name for p in (root / "results").glob("frame*"))
    assert frames == ["frame000000.png", "frame000001.png"]
    ds = ReplicaDataset(root)
    for got, want in zip(ds.frames(), seq.frames()):
        np.testing.assert_allclose(got.image, want.image, atol=1 / 255)
        np.testing.assert_allclose(got.depth, want.depth,
                                   atol=1 / REPLICA_DEPTH_SCALE)


def test_smoke_jpeg_phase_on_the_cpu():
    """chip_smoke.py's jpeg phase runs on any machine with g++: the hash
    check passes and the rates are priced."""
    fields = chip_smoke.jpeg_phase({"jpeg": jpeg, "native": native,
                                    "synth_replica": synth_replica})
    assert fields["ms"] > 0 and fields["mp_per_s"] > 0
    assert fields["replica_frame_ms"] == pytest.approx(
        fields["ms"] * chip_smoke.REPLICA_PIXELS / (600 * 512))
