from . import fasta, csv  # noqa: F401
