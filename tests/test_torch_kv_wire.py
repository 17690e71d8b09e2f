"""Port parity for the KV handoff wire codec (``gofr_tpu_torch/tpu/
kv_wire.py``) against the JAX package's (``gofr_tpu/tpu/kv_wire.py``).

- ``pack`` of the same payload gives the same bytes in both packages:
  float32 raw, bf16 raw (the port's leaves are the raw 16-bit words, the
  JAX package's ``ml_dtypes.bfloat16``), int8 with its scale planes, and
  a session-flagged payload.
- A blob either package packed unpacks in the other to equal leaves and
  header fields.
- Truncation, corruption, version skew, geometry lies and trailing bytes
  raise ``KVWireError`` in both, with the same message.
- ``resolve_codec`` and ``resolve_chunk_bytes`` (with and without the
  ``KV_WIRE_CHUNK_BYTES`` knob) agree with the JAX package's over a
  table of inputs.
- The chunk fault sites damage the stream as JAX's do, and the strict
  ``unpack`` refuses the result.
- With ``ml_dtypes`` hidden (the machine with the card has none), a bf16
  payload still round-trips, to a ``torch.bfloat16`` tensor by a view.
"""

import dataclasses
import struct
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu import faults as jax_faults
from gofr_tpu.tpu import kv_wire as jax_wire
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.tpu import faults as pt_faults
from gofr_tpu_torch.tpu import kv_wire as pt_wire

ROOT = Path(__file__).resolve().parents[1]
CASES = ["f32", "bf16", "int8", "session"]


def _leaves(codec, shape_of, bf16):
    """Seeded leaves for a payload: per name, (the JAX package's array,
    the port's array); equal bytes."""
    rng = np.random.default_rng(7)
    out = {}
    for name in jax_wire.leaf_names(codec):
        shape = shape_of(name)
        if codec == jax_wire.CODEC_INT8 and name in ("k", "v"):
            arr = rng.integers(-128, 128, size=shape, dtype=np.int8)
            out[name] = (arr, arr.copy())
        elif codec == jax_wire.CODEC_INT8:
            arr = rng.random(shape, dtype=np.float32)
            out[name] = (arr, arr.copy())
        elif bf16:
            arr = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
            out[name] = (arr, arr.view(np.uint16).copy())
        else:
            arr = rng.standard_normal(shape).astype(np.float32)
            out[name] = (arr, arr.copy())
    return out


def _payloads(case, tokens=6, page=4, n_layers=2, n_kv_heads=2,
              head_dim=4):
    """The same payload built in each package: (JAX's, the port's)."""
    codec = jax_wire.CODEC_INT8 if case == "int8" else jax_wire.CODEC_RAW
    dtype = {"f32": "float32", "int8": "int8"}.get(case, "bfloat16")
    flags = jax_wire.FLAG_SESSION if case == "session" else 0
    n_pages = -(-tokens // page)
    made = []
    for wire in (jax_wire, pt_wire):
        made.append(wire.KVPayload(
            codec=codec, dtype=dtype, page=page, tokens=tokens,
            n_layers=n_layers, n_kv_heads=n_kv_heads, head_dim=head_dim,
            n_pages=n_pages, first_token=17,
            sample_key=(0xDEADBEEF, 0x12345678), model="tiny", leaves={},
            flags=flags))
    leaves = _leaves(codec, lambda name: jax_wire.leaf_shape(made[0], name),
                     dtype == "bfloat16")
    for name, (jax_leaf, pt_leaf) in leaves.items():
        made[0].leaves[name] = jax_leaf
        made[1].leaves[name] = pt_leaf
    return made


def _fields(payload):
    return (payload.codec, payload.dtype, payload.page, payload.tokens,
            payload.n_layers, payload.n_kv_heads, payload.head_dim,
            payload.n_pages, payload.first_token, payload.sample_key,
            payload.model, payload.flags, payload.describe())


def test_port_keeps_the_wire_constants_and_names():
    assert sorted(pt_wire.__all__) == sorted(jax_wire.__all__)
    for name in ("MAGIC", "VERSION", "CODEC_RAW", "CODEC_INT8",
                 "FLAG_SESSION", "DEFAULT_CHUNK_BYTES", "MIN_CHUNK_BYTES",
                 "MAX_CHUNK_BYTES"):
        assert getattr(pt_wire, name) == getattr(jax_wire, name), name
    assert pt_wire._HEAD.format == jax_wire._HEAD.format
    assert pt_wire._SIZE.format == jax_wire._SIZE.format


@pytest.mark.parametrize("case", CASES)
def test_pack_is_byte_identical_to_jax(case):
    jax_payload, pt_payload = _payloads(case)
    blob = pt_wire.pack(pt_payload)
    assert blob == jax_wire.pack(jax_payload)
    chunks = list(pt_wire.iter_chunks(blob, chunk_bytes=64))
    assert chunks == list(jax_wire.iter_chunks(blob, chunk_bytes=64))
    assert pt_wire.assemble(chunks) == blob


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("case", CASES)
def test_blobs_cross_the_packages(case, direction):
    jax_payload, pt_payload = _payloads(case)
    if direction == "jax_to_port":
        src, blob = jax_payload, jax_wire.pack(jax_payload)
        out, want = pt_wire.unpack(blob), pt_payload
    else:
        src, blob = pt_payload, pt_wire.pack(pt_payload)
        out, want = jax_wire.unpack(blob), jax_payload
    assert _fields(out) == _fields(src)
    assert sorted(out.leaves) == sorted(want.leaves)
    for name, leaf in want.leaves.items():
        assert out.leaves[name].dtype == leaf.dtype
        assert out.leaves[name].shape == leaf.shape
        assert out.leaves[name].tobytes() == leaf.tobytes()
    if case in ("bf16", "session"):
        # the port's bf16 leaves are the words, viewed as torch bf16
        words = pt_wire.unpack(blob).leaves["k"]
        assert words.dtype == np.uint16
        as_torch = torch.from_numpy(words.view(np.int16).copy()).view(
            torch.bfloat16)
        np.testing.assert_array_equal(
            as_torch.float().numpy(),
            jax_payload.leaves["k"].astype(np.float32))


def _defects(blob):
    head = list(jax_wire._HEAD.unpack_from(blob))
    head[9] += 1                 # n_pages lies: 6 tokens of 4 need 2
    return {
        "short header": blob[:10],
        "bad magic": b"XKVW" + blob[4:],
        "version": blob[:4] + struct.pack("<H", 99) + blob[6:],
        "trailing": blob + b"\x00",
        "short leaf": blob[:-5],
        "geometry": jax_wire._HEAD.pack(*head) + blob[jax_wire._HEAD.size:],
        "codec": blob[:6] + bytes([7]) + blob[7:],
    }


@pytest.mark.parametrize("defect", ["short header", "bad magic", "version",
                                    "trailing", "short leaf", "geometry",
                                    "codec"])
def test_defects_raise_as_jax(defect):
    blob = jax_wire.pack(_payloads("bf16")[0])
    bad = _defects(blob)[defect]
    with pytest.raises(jax_wire.KVWireError) as jax_err:
        jax_wire.unpack(bad)
    with pytest.raises(pt_wire.KVWireError) as pt_err:
        pt_wire.unpack(bad)
    assert str(pt_err.value) == str(jax_err.value)
    assert pt_err.value.status_code == 400


@pytest.mark.parametrize("flaw", ["missing leaf", "wrong shape"])
def test_pack_validates_leaves_as_jax(flaw):
    errors = []
    for wire, payload in zip((jax_wire, pt_wire), _payloads("int8")):
        if flaw == "missing leaf":
            del payload.leaves["vs"]
        else:
            payload.leaves["v"] = payload.leaves["v"][:, :1]
        with pytest.raises(wire.KVWireError) as err:
            wire.pack(payload)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (ValueError, TypeError) as exc:
        return (type(exc).__name__, str(exc))


def test_resolve_codec_and_chunk_bytes_agree_with_jax(monkeypatch):
    jcfg = jax_llama.config("tiny", dtype=jnp.float32)
    pcfg = pt_llama.config("tiny", dtype=torch.float32)
    for int8 in (False, True):
        jc = dataclasses.replace(jcfg, kv_int8=int8)
        pc = dataclasses.replace(pcfg, kv_int8=int8)
        assert pt_wire.codec_for_cfg(pc) == jax_wire.codec_for_cfg(jc)
        for name in ("auto", "AUTO ", "", None, "bf16", "raw", "int8",
                     "fp8"):
            assert _outcome(pt_wire.resolve_codec, name, pc) \
                == _outcome(jax_wire.resolve_codec, name, jc), (int8, name)
    for value in (None, 1, 4096, 256 << 10, "65536", 0, -3):
        assert _outcome(pt_wire.resolve_chunk_bytes, value) \
            == _outcome(jax_wire.resolve_chunk_bytes, value), value
    for env in ("", "  ", "8192", "4096", "4194304", "1024", "lots"):
        monkeypatch.setenv("KV_WIRE_CHUNK_BYTES", env)
        assert _outcome(pt_wire.resolve_chunk_bytes) \
            == _outcome(jax_wire.resolve_chunk_bytes), env


@pytest.mark.parametrize("site", ["kv_chunk_truncate", "kv_chunk_corrupt"])
def test_chunk_fault_sites_damage_the_stream_as_jax(site):
    blob = pt_wire.pack(_payloads("f32")[1])
    streams = []
    for faults, wire in ((jax_faults, jax_wire), (pt_faults, pt_wire)):
        faults.install(faults.FaultPlan(f"{site}:@1"))
        try:
            # 16-byte frames: the truncation drops whole frames past its
            # cut, as in JAX
            streams.append(list(wire.iter_chunks(blob, chunk_bytes=16)))
            # the plan fires once: the next stream is whole
            assert wire.assemble(wire.iter_chunks(blob, 16)) == blob
        finally:
            faults.reset()
    assert streams[0] == streams[1]
    damaged = pt_wire.assemble(streams[1])
    assert damaged != blob
    with pytest.raises(pt_wire.KVWireError):
        pt_wire.unpack(damaged)


def test_bf16_round_trips_without_ml_dtypes():
    """In a process where ``ml_dtypes`` cannot be imported, the port
    packs a bf16 leaf from a ``torch.bfloat16`` tensor's words and gets
    the tensor back by a view: the same bits, no numeric cast."""
    script = """
import sys
sys.modules["ml_dtypes"] = None
import numpy as np, torch
from gofr_tpu_torch.tpu import kv_wire
try:
    import ml_dtypes
    raise SystemExit("ml_dtypes importable")
except ImportError:
    pass
x = torch.randn((2, 2, 4, 2, 8), generator=torch.Generator().manual_seed(3)
                ).to(torch.bfloat16)
words = x.view(torch.int16).numpy().view(np.uint16)
p = kv_wire.KVPayload(codec=kv_wire.CODEC_RAW, dtype="bfloat16", page=4,
                      tokens=7, n_layers=2, n_kv_heads=2, head_dim=8,
                      n_pages=2, first_token=3, sample_key=(1, 2),
                      model="m", leaves={"k": words, "v": words})
out = kv_wire.unpack(kv_wire.pack(p))
back = torch.from_numpy(out.leaves["v"].view(np.int16)).view(torch.bfloat16)
assert out.dtype == "bfloat16" and out.leaves["v"].dtype == np.uint16
assert torch.equal(back, x)
assert "ml_dtypes" not in {m for m in sys.modules if sys.modules[m]}
print("ok")
"""
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "ok"
