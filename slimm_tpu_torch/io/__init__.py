# Copied from slimm_tpu/io/__init__.py (the port imports nothing of slimm_tpu).
from .sam import AlignmentFile, RecordBatch  # noqa: F401
from .files import (  # noqa: F401
    collect_bam_files,
    get_directory,
    get_file_name,
    tsv_file_name,
)
from .fasta import read_fasta  # noqa: F401
