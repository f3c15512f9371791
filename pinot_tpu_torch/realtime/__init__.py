"""Realtime ingestion: the stream SPI, its in-memory and file-log
consumers, and the realtime table data manager."""
from .stream import (InMemoryStream, MessageBatch,  # noqa: F401
                     OffsetOutOfRange, PartitionGroupConsumer,
                     StreamConfig, StreamConsumerFactory)
from .manager import RealtimeTableDataManager  # noqa: F401
