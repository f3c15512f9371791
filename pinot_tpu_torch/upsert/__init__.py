from .metadata import (DedupConfig, PartitionDedupMetadataManager,
                       PartitionUpsertMetadataManager,
                       UpsertConfig)  # noqa: F401
