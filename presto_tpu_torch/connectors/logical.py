"""The oracle's input frames over a connector's physical arrays: what each
connector's ``table_logical`` returns, the counterpart of the JAX
package's ``table_pandas``."""

from __future__ import annotations

from typing import Mapping

import numpy as np

from presto_tpu_torch.batch import Dictionary, decode_values
from presto_tpu_torch.oracle.frame import Frame, Lazy
from presto_tpu_torch.types import DataType


def logical_frame(arrays: Mapping[str, np.ndarray], valids: Mapping[str, np.ndarray],
                  types: Mapping[str, DataType],
                  dicts: Mapping[str, Dictionary]) -> Frame:
    """The oracle's input frame over physical ``arrays``: column ``c``
    decodes by ``decode_values`` (with its valid mask and dictionary) on
    first use, and only the rows a query keeps."""

    def column(c):
        data, valid, full = arrays[c], valids.get(c), []

        def decode(rows):
            if rows is not None:
                return decode_values(data[rows], None if valid is None else valid[rows],
                                     types[c], dicts.get(c))
            if not full:
                full.append(decode_values(data, valid, types[c], dicts.get(c)))
            return full[0]
        return Lazy(len(data), decode)

    return Frame({c: column(c) for c in arrays})
