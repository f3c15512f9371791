"""The cluster roles: controller, server nodes and broker nodes over HTTP.

Port of ``pinot_tpu/cluster/``'s data plane. Server nodes serve their
segments from the card unless given ``device="cpu"``.
"""
from .controller import Controller  # noqa: F401
from .server_node import ServerNode  # noqa: F401
from .broker_node import BrokerNode  # noqa: F401
