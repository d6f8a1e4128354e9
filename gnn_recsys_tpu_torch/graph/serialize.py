"""Graph serialization: HeteroGraph <-> npz on disk.

Port of ``gnn_recsys_tpu/graph/serialize.py`` in the same file format: one
``.npz`` of arrays keyed ``rel|ndata|edata \\x1f <etype or ntype> \\x1f
<name>`` plus a JSON header under ``__header__``.  The port stores its
members uncompressed, so a load reads each member's bytes straight into its
array; the JAX package deflates them, and a deflated member is inflated.  A
``graph.npz`` written by either package loads in the other with equal
arrays.
"""

from __future__ import annotations

import json
import struct
import zipfile
from typing import Dict

import numpy as np
import torch

from gnn_recsys_tpu_torch.graph.hetero import HeteroGraph, Relation, compute_eid_pos
from gnn_recsys_tpu_torch.utils.profiling import counter


def _flat_key(*parts: str) -> str:
    return "\x1f".join(parts)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_graph(graph: HeteroGraph, path: str) -> None:
    """Write the graph to ``path`` (.npz)."""
    arrays: Dict[str, np.ndarray] = {}
    header = {"ntypes": dict(graph.num_nodes_tuple), "etypes": [], "ndata": {}}
    for et, rel in graph.rels.items():
        et_key = "/".join(et)
        header["etypes"].append({"etype": list(et), "edata": sorted(rel.edata.keys())})
        names = ["src", "dst", "nbr", "nbr_eid", "nbr_mask", "deg"]
        if rel.eid_pos is not None:
            names.append("eid_pos")
        for name in names:
            arrays[_flat_key("rel", et_key, name)] = _np(getattr(rel, name))
        for name, arr in rel.edata.items():
            arrays[_flat_key("edata", et_key, name)] = _np(arr)
    for nt, feats in graph.ndata.items():
        header["ndata"][nt] = sorted(feats.keys())
        for name, arr in feats.items():
            arrays[_flat_key("ndata", nt, name)] = _np(arr)
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


# A zip member's local file header: signature, 5 shorts, 3 ints, then the
# lengths of the name and of the extra field that precede the member's bytes.
_LOCAL_HEADER = struct.Struct("<4s5H3I2H")


def _read_stored(f, info: zipfile.ZipInfo) -> np.ndarray:
    """A stored ``.npy`` member of the zip open as ``f`` (unbuffered), read
    into a fresh array: one copy from the file."""
    f.seek(info.header_offset)
    fields = _LOCAL_HEADER.unpack(f.read(_LOCAL_HEADER.size))
    if fields[0] != b"PK\x03\x04":
        raise zipfile.BadZipFile(f"no local header for {info.filename!r}")
    start = info.header_offset + _LOCAL_HEADER.size + fields[-2] + fields[-1]
    f.seek(start)
    version = np.lib.format.read_magic(f)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran_order, dtype = read_header(f)
    arr = np.empty(shape[::-1] if fortran_order else shape, dtype)
    if f.tell() - start + arr.nbytes != info.file_size:
        raise zipfile.BadZipFile(f"{info.filename!r}: its header does not match its size")
    view = memoryview(arr.reshape(-1).view(np.uint8))
    done = 0
    while done < len(view):
        n = f.readinto(view[done:])
        if not n:
            raise EOFError(f"{info.filename!r} ends early")
        done += n
    return arr.T if fortran_order else arr


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """Every member of the ``.npz`` at ``path``, each a fresh writable array.
    A stored member is read straight into its array; a deflated one is
    inflated.  Counts each path's member bytes in ``load_graph``'s
    counters."""
    arrays = {}
    with open(path, "rb", buffering=0) as f, zipfile.ZipFile(f) as zf:
        for info in zf.infolist():
            key = info.filename.removesuffix(".npy")
            if info.compress_type == zipfile.ZIP_STORED:
                arrays[key] = _read_stored(f, info)
                load_graph.stored_bytes += info.file_size
            else:
                with zf.open(info) as member:
                    arrays[key] = np.lib.format.read_array(member)
                load_graph.inflated_bytes += info.file_size
    return arrays


def load_graph(path: str) -> HeteroGraph:
    """Read a graph written by :func:`save_graph` (of either package) onto
    the CPU.  Every tensor is writable and owns the bytes read for it.

    Counters (``utils/profiling.py:counter``, reset by the caller):
    ``load_graph.stored_bytes`` and ``load_graph.inflated_bytes``, the member
    bytes (each ``.npy``'s header and data) read stored and inflated."""
    z = _read_npz(path)
    header = json.loads(bytes(z["__header__"]).decode())

    def t(key: str) -> torch.Tensor:
        return torch.from_numpy(z[key])

    rels = {}
    for entry in header["etypes"]:
        et = tuple(entry["etype"])
        et_key = "/".join(et)

        def key(name):
            return _flat_key("rel", et_key, name)

        if key("eid_pos") in z:
            eid_pos = t(key("eid_pos"))
        else:  # written before eid_pos existed: recompute
            eid_pos = torch.from_numpy(compute_eid_pos(
                z[key("nbr_eid")], z[key("nbr_mask")], int(z[key("src")].shape[0])
            ))
        # Normalize the -1 padding invariant for files from old writers.
        nbr_mask = t(key("nbr_mask"))
        nbr = t(key("nbr")).to(torch.int32).masked_fill_(~nbr_mask, -1)
        rels[et] = Relation(
            src=t(key("src")), dst=t(key("dst")), nbr=nbr,
            nbr_eid=t(key("nbr_eid")), nbr_mask=nbr_mask,
            deg=t(key("deg")),
            edata={name: t(_flat_key("edata", et_key, name)) for name in entry["edata"]},
            eid_pos=eid_pos,
        )
    ndata = {
        nt: {name: t(_flat_key("ndata", nt, name)) for name in names}
        for nt, names in header["ndata"].items()
    }
    for nt in header["ntypes"]:
        ndata.setdefault(nt, {})
    return HeteroGraph(
        rels=rels, ndata=ndata,
        num_nodes_tuple=tuple(sorted(header["ntypes"].items())),
    )


counter(load_graph, "stored_bytes", "inflated_bytes")
