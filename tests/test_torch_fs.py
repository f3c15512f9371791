"""The port's PinotFS clients and stub stores against the JAX package's.

``pinot_tpu_torch/fs`` is the reference's ``pinot_tpu/fs``: the S3
(SigV4 REST), GCS (JSON API), WebHDFS and ADLS Gen2 clients and the
in-process stores that speak their wire protocols on loopback. Client
and store share only the wire, so each test runs a port client against
the reference's store and the reference's client against the port's
store: uploads, ranged downloads, listings, server-side copies, moves,
deletes and retries under injected failures must behave alike, and
SigV4 must sign the same bytes for a fixed clock. Registered, each
client resolves its scheme through ``spi.filesystem.fs_for_uri``; until
then the scheme stays gated with the reference's message.
"""
import os

import pytest

import pinot_tpu.fs as jfs
import pinot_tpu.fs.stub as jstub
import pinot_tpu.fs.stub_cloud as jcloud
import pinot_tpu.spi.filesystem as jspi
import pinot_tpu_torch.fs as tfs
import pinot_tpu_torch.fs.stub as tstub
import pinot_tpu_torch.fs.stub_cloud as tcloud
import pinot_tpu_torch.spi.filesystem as tspi
from pinot_tpu_torch.fs import common as tcommon

AK, SK = "ak-fs", "sk-fs"
STORES = ("s3", "gcs", "hdfs", "adls")
PAIRS = ("port_client_on_reference_store", "reference_client_on_port_store")


def _make(store: str, fs_pkg, stub_pkg, cloud_pkg):
    """(PinotFS, base path, server) of ``store``: the client from
    ``fs_pkg``, the server from the stub modules given."""
    if store == "s3":
        srv = stub_pkg.FakeS3Server(access_key=AK, secret_key=SK)
        fs = fs_pkg.S3PinotFS(fs_pkg.S3Client(srv.endpoint_url, AK, SK,
                                              backoff=0.01))
        return fs, "bkt/data", srv
    if store == "gcs":
        srv = cloud_pkg.FakeGcsServer(token="tok")
        fs = fs_pkg.GcsPinotFS(fs_pkg.GcsClient(srv.endpoint_url,
                                                token="tok", backoff=0.01))
        return fs, "bkt/data", srv
    if store == "hdfs":
        srv = cloud_pkg.FakeWebHdfsServer()
        fs = fs_pkg.HdfsPinotFS(fs_pkg.WebHdfsClient(
            srv.endpoint_url, user="pinot", backoff=0.01))
        return fs, "/data", srv
    srv = cloud_pkg.FakeAdlsServer(token="az")
    fs = fs_pkg.AdlsPinotFS(fs_pkg.AdlsClient(srv.endpoint_url, token="az",
                                              backoff=0.01))
    return fs, "fsys/data", srv


@pytest.fixture(params=[(s, p) for s in STORES for p in PAIRS],
                ids=lambda sp: f"{sp[0]}-{sp[1]}")
def crossed(request):
    store, pair = request.param
    if pair == PAIRS[0]:
        made = _make(store, tfs, jstub, jcloud)
    else:
        made = _make(store, jfs, tstub, tcloud)
    yield made
    _stop_soon(made[2])


def _stop_soon(*servers):
    """Stop the stores without waiting out each one's shutdown poll."""
    import threading

    for srv in servers:
        threading.Thread(target=srv.stop, daemon=True).start()


def test_file_tree_and_retries(crossed, tmp_path):
    fs, base, srv = crossed
    payload = os.urandom(70_000)
    src = tmp_path / "seg.bin"
    src.write_bytes(payload)
    fs.copy_from_local(str(src), f"{base}/seg.bin")
    assert fs.exists(f"{base}/seg.bin")
    assert fs.length(f"{base}/seg.bin") == len(payload)
    fs.copy_to_local(f"{base}/seg.bin", str(tmp_path / "back.bin"))
    assert (tmp_path / "back.bin").read_bytes() == payload
    tree = tmp_path / "tree"
    for name in ("a.txt", "b.txt", "sub/c.txt"):
        (tree / name).parent.mkdir(parents=True, exist_ok=True)
        (tree / name).write_bytes(name.encode() * 3)
    fs.copy_from_local(str(tree), f"{base}/tree")
    names = fs.listdir(f"{base}/tree")
    assert "a.txt" in names and "b.txt" in names
    assert any(n.startswith("sub") for n in names)
    fs.copy(f"{base}/tree/a.txt", f"{base}/tree/a2.txt")
    fs.move(f"{base}/tree/b.txt", f"{base}/tree/b2.txt")
    assert fs.exists(f"{base}/tree/a.txt") and fs.exists(
        f"{base}/tree/a2.txt")
    assert not fs.exists(f"{base}/tree/b.txt")
    fs.copy_to_local(f"{base}/tree/b2.txt", str(tmp_path / "b2"))
    assert (tmp_path / "b2").read_bytes() == b"b.txt" * 3
    assert fs.delete(f"{base}/tree/a2.txt")
    assert not fs.exists(f"{base}/tree/a2.txt")
    assert not fs.delete(f"{base}/tree/nope.txt")
    # reads retry past injected 5xx answers (fewer than the clients'
    # retries); bodies are not re-sent, as in the reference
    (tmp_path / "x").write_bytes(b"retry me")
    fs.copy_from_local(str(tmp_path / "x"), f"{base}/x")
    srv.inject_failures(2)
    assert fs.length(f"{base}/x") == 8
    srv.inject_failures(2)
    fs.copy_to_local(f"{base}/x", str(tmp_path / "y"))
    assert (tmp_path / "y").read_bytes() == b"retry me"
    srv.inject_failures(0)


@pytest.mark.parametrize("method,uri,query,headers,payload", [
    ("GET", "/examplebucket/test.txt", {}, {"range": "bytes=0-9"}, b""),
    ("PUT", "/b/k with space/x.bin", {"partNumber": "2", "uploadId": "u/1"},
     {"content-type": "application/octet-stream"}, b"payload" * 9),
    ("POST", "/", {"list-type": "2", "prefix": "a b/"},
     {"x-amz-target": "Kinesis_20131202.PutRecord"}, b"{}"),
])
def test_sigv4_signs_the_same_bytes(method, uri, query, headers, payload):
    import hashlib

    sha = hashlib.sha256(payload).hexdigest()
    args = (method, "127.0.0.1:9000", uri, query, headers, sha, AK, SK,
            "us-east-1", "20260102T030405Z")
    assert tfs.sigv4_headers(*args) == jfs.sigv4_headers(*args)
    assert tfs.sigv4_headers(*args, service="kinesis") == \
        jfs.sigv4_headers(*args, service="kinesis")


def test_a_bad_signature_is_refused_by_either_store():
    for client_pkg, stub_pkg in ((tfs, jstub), (jfs, tstub)):
        srv = stub_pkg.FakeS3Server(access_key=AK, secret_key=SK)
        try:
            bad = client_pkg.S3Client(srv.endpoint_url, AK, "wrong",
                                      backoff=0.01)
            with pytest.raises(Exception, match="SignatureDoesNotMatch"):
                bad.get_object("b", "k")
        finally:
            _stop_soon(srv)


def test_multipart_upload_across_packages(tmp_path):
    payload = os.urandom(5 * 1024 + 17)
    for client_pkg, stub_pkg in ((tfs, jstub), (jfs, tstub)):
        srv = stub_pkg.FakeS3Server(access_key=AK, secret_key=SK)
        try:
            c = client_pkg.S3Client(srv.endpoint_url, AK, SK, backoff=0.01,
                                    part_size=1024)
            src = tmp_path / "big.bin"
            src.write_bytes(payload)
            fs = client_pkg.S3PinotFS(c)
            fs.copy_from_local(str(src), "b/big.bin")
            assert c.get_object("b", "big.bin") == payload
            assert c.get_object("b", "big.bin", (100, 199)) == \
                payload[100:200]
        finally:
            _stop_soon(srv)


def test_schemes_resolve_once_registered():
    s3 = tstub.FakeS3Server(access_key=AK, secret_key=SK)
    gcs, hdfs, adls = (tcloud.FakeGcsServer(), tcloud.FakeWebHdfsServer(),
                       tcloud.FakeAdlsServer())
    saved = dict(tspi._REGISTRY)
    try:
        for scheme in ("s3", "gs", "hdfs", "abfs"):
            fs, _path = tspi.fs_for_uri(f"{scheme}://x/y")
            with pytest.raises(RuntimeError) as mine:
                fs.exists("x/y")
            ref, _p = jspi.fs_for_uri(f"{scheme}://x/y")
            with pytest.raises(RuntimeError) as theirs:
                ref.exists("x/y")
            assert str(mine.value).replace("pinot_tpu_torch.", "") == \
                str(theirs.value).replace("pinot_tpu.", "")
        made = {
            "s3": tfs.S3PinotFS.register(endpoint_url=s3.endpoint_url,
                                         access_key=AK, secret_key=SK),
            "gs": tfs.GcsPinotFS.register(endpoint_url=gcs.endpoint_url),
            "hdfs": tfs.HdfsPinotFS.register(
                endpoint_url=hdfs.endpoint_url),
            "abfs": tfs.AdlsPinotFS.register(
                endpoint_url=adls.endpoint_url),
        }
        for scheme, fs in made.items():
            got, path = tspi.fs_for_uri(f"{scheme}://bkt/a/b")
            assert got is fs and path.endswith("a/b")
        assert tspi.fs_for_uri("abfss://bkt/a")[0] is made["abfs"]
    finally:
        tspi._REGISTRY.clear()
        tspi._REGISTRY.update(saved)
        tspi._INSTANCES.clear()
        _stop_soon(s3, gcs, hdfs, adls)


def test_common_helpers_match_reference(tmp_path):
    from pinot_tpu.fs import common as jcommon

    assert tcommon.bearer_headers("t") == jcommon.bearer_headers("t")
    assert tcommon.bearer_headers(lambda: "u") == {
        "Authorization": "Bearer u"}
    assert tcommon.bearer_headers(None) == {}
    for path in ("bkt/k/x", "/bkt/k", "bkt"):
        assert tcommon.split_bucket_path(path, "s3") == \
            jcommon.split_bucket_path(path, "s3")
    with pytest.raises(ValueError, match="needs a bucket"):
        tcommon.split_bucket_path("/", "gs")
    data = os.urandom(1000)
    tcommon.download_ranged(lambda lo, hi: data[lo:hi + 1], len(data),
                            str(tmp_path / "d" / "f"), 333)
    assert (tmp_path / "d" / "f").read_bytes() == data
