"""Filesystem plugins (pinot-plugins/pinot-file-system analog): S3
(SigV4 REST), GCS (JSON API), HDFS (WebHDFS), ADLS Gen2 (dfs), and the
shared REST transport.

Port of ``pinot_tpu/fs/``. Each client registers its scheme with
``spi.filesystem`` when told to (``S3PinotFS.register(...)`` and the
like); ``fs/stub.py`` and ``fs/stub_cloud.py`` are the in-process stores
that speak the same wire protocols on loopback.
"""
from .adls import AdlsClient, AdlsPinotFS  # noqa: F401
from .gcs import GcsClient, GcsPinotFS  # noqa: F401
from .hdfs import HdfsPinotFS, WebHdfsClient  # noqa: F401
from .rest import RestClient, RestError  # noqa: F401
from .s3 import S3Client, S3Error, S3PinotFS, sigv4_headers  # noqa: F401
