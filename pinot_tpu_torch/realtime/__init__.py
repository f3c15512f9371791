"""Realtime ingestion: the stream SPI, its in-memory and file-log
consumers, the realtime table data manager, and the wire-protocol stream
plugins (``wirestream``, ``kafka``, ``pulsar``, ``kinesis``: each a
client for its protocol and an in-process fake broker speaking it),
imported by their module paths as in the reference."""
from .stream import (InMemoryStream, MessageBatch,  # noqa: F401
                     OffsetOutOfRange, PartitionGroupConsumer,
                     StreamConfig, StreamConsumerFactory)
from .manager import RealtimeTableDataManager  # noqa: F401
