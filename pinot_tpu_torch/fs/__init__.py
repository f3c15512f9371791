"""Filesystem plugins: the shared REST transport and the S3 request
signer that the Kinesis stream client uses.

Port of ``pinot_tpu/fs/``'s ``rest.py`` and the SigV4 part of ``s3.py``.
The PinotFS clients (S3, GCS, HDFS, ADLS) come with the cluster plane.
"""
from .rest import RestClient, RestError  # noqa: F401
from .s3 import S3Error, sigv4_headers  # noqa: F401
