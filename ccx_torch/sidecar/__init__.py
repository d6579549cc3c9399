"""The optimizer sidecar of the port: gRPC service, client and CLI.

Only wire-contract constants live here, so the remote client
(``ccx_torch.sidecar.client``) stays importable without torch or the
optimizer stack. ``SERVICE`` is the wire contract's service name, shared
with the JAX package's sidecar and the JVM bridge.
"""

SERVICE = "ccx.sidecar.OptimizerService"

#: channel/server options shared by both ends of the hop: a 100k-partition
#: snapshot is megabytes packed and gRPC's 4 MB default max rejects it
GRPC_MESSAGE_OPTIONS = (
    ("grpc.max_send_message_length", 256 * 1024 * 1024),
    ("grpc.max_receive_message_length", 256 * 1024 * 1024),
)


def identity(b: bytes) -> bytes:
    """Byte-identity (de)serializer — payloads are msgpack end to end."""
    return b
