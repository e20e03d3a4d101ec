from ydb_tpu_torch.blocks.block import Column, TableBlock  # noqa: F401
from ydb_tpu_torch.blocks.dictionary import Dictionary, DictionarySet  # noqa: F401
