"""Real ONNX emission — interop parity with export-onnx.ipynb cell 11; the
JAX package's ``infer/onnx_model.py``, copied.  The one change: the weights
are read from the port's tensors (``.detach().cpu().numpy()``).  For the
same weights the bytes are the JAX writer's, in every flavor.

The reference's export deliverable is ``torch.onnx.export(raw_model,
torch.randn(1024), "rawaudiovae.onnx")``: an ONNX graph of the full forward
(encode → stochastic reparameterize → decode) at a fixed (1024,) input,
consumable by any ONNX runtime.  The image ships neither ``onnx`` nor a
compiled ``onnx.proto``, so this module writes the protobuf **wire format by
hand** — the model is five MatMul/Add pairs plus Relu/Tanh/Exp/Mul and one
RandomNormalLike, so the required subset of the ONNX schema is tiny and
stable (field numbers below are fixed by onnx/onnx.proto, IR version 8,
default opset 17).

Three graph flavors:

  * reference parity (``batch=None``): fixed ``(segment,)`` input, Reshape to
    ``(-1, segment)``, stochastic reparameterization via RandomNormalLike —
    node-for-node what torch.onnx.export emits for ``VAE.forward``
    (rawvae/model.py:32-35), outputs ``(recon, mu, logvar)``;
  * dynamic batch (``batch="N"``): symbolic batch dim (quirk #18 fix — the
    reference's export had no dynamic axes);
  * deterministic (``deterministic=True``): ``z = mu`` (quirk #13 extension),
    a pure-function graph for runtimes without RandomNormalLike support.

Because no ONNX runtime exists in this image, :class:`OnnxModel` also
implements a **decoder** of the same wire subset and a numpy evaluator for
the emitted node set — the documented consumer the tests use to round-trip
the artifact bytes numerically against the forward.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

# ---------------------------------------------------------------- protobuf --
# Wire format: each field = varint key (field_number << 3 | wire_type) then
# payload.  Wire types used: 0 = varint, 2 = length-delimited, 5 = 32-bit.

_FLOAT = 1   # TensorProto.DataType.FLOAT
_INT64 = 7   # TensorProto.DataType.INT64


def _varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # protobuf encodes negatives as 10-byte varints
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _field_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _field_bytes(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _field_str(field: int, text: str) -> bytes:
    return _field_bytes(field, text.encode("utf-8"))


def _field_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


# ------------------------------------------------------------- ONNX writer --

def _tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float32:
        dtype = _FLOAT
    elif arr.dtype == np.int64:
        dtype = _INT64
    else:
        raise TypeError(f"unsupported initializer dtype {arr.dtype}")
    out = b"".join(_field_varint(1, int(d)) for d in arr.shape)
    out += _field_varint(2, dtype)
    out += _field_str(8, name)
    out += _field_bytes(9, arr.tobytes())
    return out


def _value_info(name: str, dims: Sequence[Union[int, str]],
                elem_type: int = _FLOAT) -> bytes:
    """ValueInfoProto: name=1, type=2 → TypeProto.tensor_type=1 →
    {elem_type=1, shape=2 → dim=1 → {dim_value=1 | dim_param=2}}."""
    dim_payload = b""
    for d in dims:
        if isinstance(d, str):
            dim_payload += _field_bytes(1, _field_str(2, d))
        else:
            dim_payload += _field_bytes(1, _field_varint(1, int(d)))
    tensor_type = _field_varint(1, elem_type) + _field_bytes(2, dim_payload)
    type_proto = _field_bytes(1, tensor_type)
    return _field_str(1, name) + _field_bytes(2, type_proto)


def _attr_int(name: str, value: int) -> bytes:
    # AttributeProto: name=1, i=3, type=20 (INT=2)
    return _field_str(1, name) + _field_varint(3, value) + _field_varint(20, 2)


def _attr_float(name: str, value: float) -> bytes:
    return _field_str(1, name) + _field_float(2, value) + _field_varint(20, 1)


def _node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
          name: str = "", attrs: Sequence[bytes] = ()) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b"".join(_field_str(1, i) for i in inputs)
    out += b"".join(_field_str(2, o) for o in outputs)
    if name:
        out += _field_str(3, name)
    out += _field_str(4, op_type)
    out += b"".join(_field_bytes(5, a) for a in attrs)
    return out


def _graph(name: str, nodes: Sequence[bytes], initializers: Sequence[bytes],
           inputs: Sequence[bytes], outputs: Sequence[bytes]) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    out = b"".join(_field_bytes(1, n) for n in nodes)
    out += _field_str(2, name)
    out += b"".join(_field_bytes(5, t) for t in initializers)
    out += b"".join(_field_bytes(11, i) for i in inputs)
    out += b"".join(_field_bytes(12, o) for o in outputs)
    return out


def _model(graph: bytes, opset: int = 17) -> bytes:
    """ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8."""
    opset_id = _field_varint(2, opset)  # OperatorSetIdProto: version=2
    return (_field_varint(1, 8)
            + _field_str(2, "rawaudiovae_kelsey_tpu")
            + _field_bytes(7, graph)
            + _field_bytes(8, opset_id))


def _linear(nodes: List[bytes], x: str, w: str, b: str, out: str) -> None:
    nodes.append(_node("MatMul", [x, w], [out + "_mm"], out + "/matmul"))
    nodes.append(_node("Add", [out + "_mm", b], [out], out + "/bias"))


def export_onnx(model, params, path: Union[str, Path],
                batch: Optional[Union[int, str]] = None,
                deterministic: bool = False, seed: Optional[int] = None,
                ) -> Path:
    """Write a loadable ``.onnx`` of the dense VAE forward.

    ``batch=None`` reproduces the reference artifact's contract — a flat
    ``(segment,)`` input reshaped to ``(-1, segment)`` inside the graph (the
    ``x.view(-1, segment)`` at rawvae/model.py:33).  An int or a string dim
    name exports a batched ``(batch, segment)`` input instead.  Outputs are
    ``recon, mu, logvar`` — the tuple ``VAE.forward`` returns.
    """
    if model.name != "dense":
        raise ValueError(
            "ONNX export covers the dense reference family; use "
            "export_program for the deep/conv variants"
        )
    seg = model.segment_length
    weights = {}
    for layer in ("fc1", "fc21", "fc22", "fc3", "fc4"):
        for k in ("w", "b"):
            weights[f"{layer}_{k}"] = np.asarray(
                params[layer][k].detach().cpu().numpy(), np.float32)

    nodes: List[bytes] = []
    inits = [_tensor(k, v) for k, v in weights.items()]

    if batch is None:
        in_dims: List[Union[int, str]] = [seg]
        inits.append(_tensor("reshape_shape",
                             np.asarray([-1, seg], np.int64)))
        nodes.append(_node("Reshape", ["input", "reshape_shape"], ["x2d"],
                           "reshape"))
        x = "x2d"
        out_batch: Union[int, str] = 1
    else:
        in_dims = [batch, seg]
        x = "input"
        out_batch = batch

    _linear(nodes, x, "fc1_w", "fc1_b", "pre_h1")
    nodes.append(_node("Relu", ["pre_h1"], ["h1"], "enc/relu"))
    _linear(nodes, "h1", "fc21_w", "fc21_b", "mu")
    _linear(nodes, "h1", "fc22_w", "fc22_b", "logvar")

    if deterministic:
        z = "mu"
    else:
        inits.append(_tensor("half", np.asarray(0.5, np.float32)))
        nodes.append(_node("Mul", ["logvar", "half"], ["half_logvar"],
                           "reparam/half"))
        nodes.append(_node("Exp", ["half_logvar"], ["std"], "reparam/std"))
        rnl_attrs = [_attr_int("dtype", _FLOAT)]
        if seed is not None:
            rnl_attrs.append(_attr_float("seed", float(seed)))
        nodes.append(_node("RandomNormalLike", ["std"], ["eps"],
                           "reparam/eps", rnl_attrs))
        nodes.append(_node("Mul", ["eps", "std"], ["eps_std"],
                           "reparam/scale"))
        nodes.append(_node("Add", ["mu", "eps_std"], ["z"], "reparam/shift"))
        z = "z"

    _linear(nodes, z, "fc3_w", "fc3_b", "pre_h3")
    nodes.append(_node("Relu", ["pre_h3"], ["h3"], "dec/relu"))
    _linear(nodes, "h3", "fc4_w", "fc4_b", "pre_recon")
    nodes.append(_node("Tanh", ["pre_recon"], ["recon"], "dec/tanh"))

    graph = _graph(
        "rawaudiovae",
        nodes, inits,
        inputs=[_value_info("input", in_dims)],
        outputs=[
            _value_info("recon", [out_batch, seg]),
            _value_info("mu", [out_batch, model.latent_dim]),
            _value_info("logvar", [out_batch, model.latent_dim]),
        ],
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(_model(graph))
    return path


# ------------------------------------------------- decoder + numpy runtime --

class OnnxDecodeError(ValueError):
    """Raised for any structurally invalid ONNX byte stream — truncated
    buffers, lengths past the end, bad wire types, non-UTF8 names, tensor
    payloads that don't match their declared dims.  The single exception
    surface the fuzz tests pin."""


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 2:
            size, pos = _read_varint(data, pos)
            if size > n - pos:
                raise OnnxDecodeError(
                    f"length-delimited field of {size} bytes at offset "
                    f"{pos} overruns the {n}-byte message"
                )
            value = data[pos:pos + size]
            pos += size
        elif wire == 5:
            if n - pos < 4:
                raise OnnxDecodeError("truncated fixed32 field")
            value = struct.unpack_from("<f", data, pos)[0]
            pos += 4
        elif wire == 1:
            if n - pos < 8:
                raise OnnxDecodeError("truncated fixed64 field")
            value = struct.unpack_from("<d", data, pos)[0]
            pos += 8
        else:
            raise OnnxDecodeError(f"unsupported wire type {wire}")
        yield field, wire, value


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data):
            raise OnnxDecodeError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise OnnxDecodeError("varint longer than 64 bits")


def _parse_tensor(data: bytes) -> tuple[str, np.ndarray]:
    dims, dtype, name, raw = [], _FLOAT, "", b""
    for field, _w, value in _iter_fields(data):
        if field == 1:
            dims.append(value)
        elif field == 2:
            dtype = value
        elif field == 8:
            name = value.decode()
        elif field == 9:
            raw = value
    np_dtype = {_FLOAT: np.float32, _INT64: np.int64}[dtype]
    return name, np.frombuffer(raw, np_dtype).reshape(dims).copy()


def _parse_attr(data: bytes) -> tuple[str, object]:
    """AttributeProto: name=1, f=2, i=3, t=5 (TensorProto), type=20.
    Tensor attrs (type TENSOR=4) are what torch's exporter uses for
    Constant nodes — parsing them lets the evaluator run graphs produced
    by ``torch.onnx.export``, not only our own emitter's."""
    name, ival, fval, tval, atype = "", None, None, None, 0
    for field, _w, value in _iter_fields(data):
        if field == 1:
            name = value.decode()
        elif field == 2:
            fval = value
        elif field == 3:
            ival = value
        elif field == 5:
            tval = _parse_tensor(value)[1]
        elif field == 20:
            atype = value
    if atype == 1:
        return name, fval
    if atype == 4:
        return name, tval
    return name, ival


class _Node:
    __slots__ = ("op_type", "inputs", "outputs", "name", "attrs")

    def __init__(self, data: bytes):
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.name = ""
        self.op_type = ""
        self.attrs: Dict[str, object] = {}
        for field, _w, value in _iter_fields(data):
            if field == 1:
                self.inputs.append(value.decode())
            elif field == 2:
                self.outputs.append(value.decode())
            elif field == 3:
                self.name = value.decode()
            elif field == 4:
                self.op_type = value.decode()
            elif field == 5:
                k, v = _parse_attr(value)
                self.attrs[k] = v


def _parse_io_name(data: bytes) -> str:
    for field, _w, value in _iter_fields(data):
        if field == 1:
            return value.decode()
    return ""


class OnnxModel:
    """Decoded ONNX model + a numpy evaluator for the emitted node set.

    The documented consumer for artifacts written by :func:`export_onnx`
    (this image has no onnxruntime): parses the real bytes and executes
    MatMul/Add/Mul/Reshape/Relu/Tanh/Exp/RandomNormalLike with numpy —
    plus Gemm and Constant, which ``torch.onnx.export`` emits for the same
    model, so the decoder/evaluator is cross-validated against torch's
    independently produced bytes, not only against this module's own
    emitter.
    """

    def __init__(self, data: bytes):
        try:
            self._parse(data)
        except OnnxDecodeError:
            raise
        except (ValueError, KeyError, TypeError, AttributeError,
                UnicodeDecodeError, OverflowError, MemoryError) as e:
            # whatever a malformed stream trips inside numpy/str decoding
            # surfaces as the one documented decode error
            raise OnnxDecodeError(f"malformed ONNX bytes: {e}") from e

    def _parse(self, data: bytes) -> None:
        self.ir_version = 0
        self.opset = 0
        graph = b""
        for field, _w, value in _iter_fields(data):
            if field == 1:
                self.ir_version = value
            elif field == 7:
                graph = value
            elif field == 8:
                for f2, _w2, v2 in _iter_fields(value):
                    if f2 == 2:
                        self.opset = v2
        self.nodes: List[_Node] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        for field, _w, value in _iter_fields(graph):
            if field == 1:
                self.nodes.append(_Node(value))
            elif field == 5:
                name, arr = _parse_tensor(value)
                self.initializers[name] = arr
            elif field == 11:
                self.inputs.append(_parse_io_name(value))
            elif field == 12:
                self.outputs.append(_parse_io_name(value))

    @classmethod
    def load(cls, path: Union[str, Path]) -> "OnnxModel":
        return cls(Path(path).read_bytes())

    def run(self, feeds: Mapping[str, np.ndarray],
            rng: Optional[np.random.Generator] = None,
            ) -> Dict[str, np.ndarray]:
        env: Dict[str, np.ndarray] = dict(self.initializers)
        for k, v in feeds.items():
            env[k] = np.asarray(v, np.float32)
        caller_rng = rng is not None
        rng = rng or np.random.default_rng(0)
        for node in self.nodes:
            ins = [env[i] for i in node.inputs]
            op = node.op_type
            if op == "MatMul":
                out = ins[0] @ ins[1]
            elif op == "Add":
                out = ins[0] + ins[1]
            elif op == "Mul":
                out = ins[0] * ins[1]
            elif op == "Reshape":
                out = ins[0].reshape([int(d) for d in ins[1]])
            elif op == "Relu":
                out = np.maximum(ins[0], 0.0)
            elif op == "Tanh":
                out = np.tanh(ins[0])
            elif op == "Exp":
                out = np.exp(ins[0])
            elif op == "Gemm":
                # torch exports nn.Linear as Gemm (alpha·A·B + beta·C,
                # transB=1 for the (out, in) weight layout) — supported so
                # the evaluator runs torch.onnx.export artifacts too
                a, b = ins[0], ins[1]
                if node.attrs.get("transA"):
                    a = a.T
                if node.attrs.get("transB"):
                    b = b.T
                # spec defaults are 1.0, but an EXPLICIT 0.0 must zero the
                # term (`or` would coerce it back to 1.0)
                alpha = node.attrs.get("alpha")
                beta = node.attrs.get("beta")
                out = (1.0 if alpha is None else float(alpha)) * (a @ b)
                if len(ins) > 2:
                    out = out + (1.0 if beta is None
                                 else float(beta)) * ins[2]
            elif op == "Constant":
                out = node.attrs["value"]
            elif op == "RandomNormalLike":
                # honor the artifact's seed attribute (export_onnx(seed=…))
                # when the caller didn't inject an rng — otherwise two
                # differently-seeded artifacts would evaluate identically
                # here while diverging in a seed-honoring external runtime
                node_seed = node.attrs.get("seed")
                use = (np.random.default_rng(int(node_seed))
                       if not caller_rng and node_seed is not None else rng)
                out = use.standard_normal(ins[0].shape).astype(np.float32)
            else:
                raise NotImplementedError(f"op {op}")
            out = np.asarray(out)
            if out.dtype != np.int64:  # keep shape tensors integral
                out = out.astype(np.float32)
            env[node.outputs[0]] = out
        return {name: env[name] for name in self.outputs}
