"""Checkpoint metadata (a copy of
``paddle_tpu/distributed/checkpoint/metadata.py``): one JSON document a
checkpoint. Each tensor entry records the global shape and dtype (the
numpy name; ``"bfloat16"`` for bf16) and its shards, each with the
half-open index box it covers and the ``.npy`` file holding it.
"""
from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass
class ShardMeta:
    file: str  # relative .npy path
    box: list  # [[start, stop], ...] per dim (global coordinates)


@dataclasses.dataclass
class TensorMeta:
    shape: list
    dtype: str
    shards: list  # [ShardMeta]


@dataclasses.dataclass
class Metadata:
    tensors: dict  # name -> TensorMeta
    scalars: dict  # name -> python scalar (ints/floats/str/bool/None)
    version: int = 1

    def to_json(self):
        return json.dumps(
            {
                "version": self.version,
                "tensors": {
                    k: {
                        "shape": t.shape,
                        "dtype": t.dtype,
                        "shards": [
                            {"file": s.file, "box": s.box} for s in t.shards
                        ],
                    }
                    for k, t in self.tensors.items()
                },
                "scalars": self.scalars,
            },
            indent=1,
        )

    @classmethod
    def from_json(cls, text):
        d = json.loads(text)
        return cls(
            tensors={
                k: TensorMeta(
                    shape=t["shape"],
                    dtype=t["dtype"],
                    shards=[
                        ShardMeta(file=s["file"], box=s["box"])
                        for s in t["shards"]
                    ],
                )
                for k, t in d["tensors"].items()
            },
            scalars=d.get("scalars", {}),
            version=d.get("version", 1),
        )


METADATA_FILE = "metadata.json"


def metadata_path(dirname):
    return os.path.join(dirname, METADATA_FILE)
