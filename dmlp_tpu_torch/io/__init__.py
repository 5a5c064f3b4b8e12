"""I/O layer: the reference harness contract (grammar, checksum, report),
kept as the port's own copy so the port never imports ``dmlp_tpu``."""

from dmlp_tpu_torch.io.grammar import (  # noqa: F401
    Params,
    KNNInput,
    parse_input,
    parse_input_text,
    format_input,
    parse_update,
    subset_queries,
)
from dmlp_tpu_torch.io.checksum import fnv1a_checksum, FNV_BASIS, FNV_PRIME  # noqa: F401
from dmlp_tpu_torch.io.report import format_results, QueryResult  # noqa: F401
from dmlp_tpu_torch.io.datagen import generate_input_text  # noqa: F401
