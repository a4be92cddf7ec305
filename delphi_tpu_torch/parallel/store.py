"""The durable store's write and read side: every artifact the port writes
to disk goes through here, in the JAX package's envelope format, so each
package reads the other's files.

Envelope (one header line, then the raw payload bytes)::

    #DELPHI-STORE v1 <schema> <length> <crc32hex>\\n
    <payload bytes>

The header names what the artifact is, its payload length (a truncated
write shows) and a crc32 of the payload (a damaged one shows). JSONL
payloads stay line-parseable when ``#``-prefixed lines are skipped.

Writes go to a temporary file in the same directory, which is fsynced,
renamed over the destination and followed by an fsync of the directory,
so a crash leaves either the old file or the new one.

A read returns ``(payload, status)``, status one of ``ok``, ``missing``,
``legacy`` (no envelope header) or ``corrupt``. Moving corrupt files into
a quarantine directory, the quota sweep and fault injection are not
ported yet (queue 1 items 7b and 8 of ``ROADMAP.md``): a corrupt file is
reported and left where it is.
"""

import json
import os
import tempfile
import zlib
from typing import Any, Iterable, List, Optional, Tuple

from delphi_tpu_torch.utils import counter_inc, setup_logger

_logger = setup_logger()

MAGIC = b"#DELPHI-STORE"
ENVELOPE_VERSION = 1

_TMP_PREFIX = ".store_"


class StoreCorrupt(RuntimeError):
    """An envelope failed validation: a garbled header, another version or
    schema, a truncated payload or a crc mismatch."""


def encode_envelope(payload: bytes, schema: str) -> bytes:
    """Frames payload bytes: magic, version, schema tag, length, crc32."""
    if not isinstance(payload, bytes):
        raise TypeError(f"payload must be bytes, got {type(payload)}")
    header = (f"{MAGIC.decode()} v{ENVELOPE_VERSION} {schema} "
              f"{len(payload)} {zlib.crc32(payload) & 0xFFFFFFFF:08x}\n")
    return header.encode("ascii") + payload


def decode_envelope(blob: bytes,
                    schema: Optional[str] = None) -> Tuple[bytes, str]:
    """Validates a framed blob and returns ``(payload, schema_tag)``.
    Raises :class:`StoreCorrupt` on any defect, and ``ValueError`` for a
    blob without the magic prefix (a file written before the envelope)."""
    if not blob.startswith(MAGIC):
        raise ValueError("not a delphi-store envelope")
    nl = blob.find(b"\n")
    if nl < 0:
        raise StoreCorrupt("envelope header truncated (no newline)")
    try:
        fields = blob[:nl].decode("ascii").split()
    except UnicodeDecodeError as e:
        raise StoreCorrupt(f"envelope header undecodable: {e}")
    if len(fields) != 5:
        raise StoreCorrupt(
            f"envelope header malformed ({len(fields)} fields, want 5)")
    _, version, tag, length, crc_hex = fields
    if version != f"v{ENVELOPE_VERSION}":
        raise StoreCorrupt(f"unknown envelope version {version!r}")
    if schema is not None and tag != schema:
        raise StoreCorrupt(
            f"schema mismatch: file says {tag!r}, expected {schema!r}")
    try:
        want_len = int(length)
        want_crc = int(crc_hex, 16)
    except ValueError:
        raise StoreCorrupt("envelope length/crc fields unparsable")
    payload = blob[nl + 1:]
    if len(payload) != want_len:
        raise StoreCorrupt(
            f"payload truncated: {len(payload)} bytes, header "
            f"promised {want_len}")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != want_crc:
        raise StoreCorrupt("payload crc32 mismatch")
    return payload, tag


def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return  # no directory fds on this platform: the rename must do
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_bytes(path: str, payload: bytes, *, schema: str, site: str) -> None:
    """Writes one envelope-framed artifact crash-consistently. ``site``
    names the writer in the log. Raises ``OSError`` upward."""
    blob = encode_envelope(payload, schema)
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=_TMP_PREFIX, dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(directory)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    counter_inc("store.writes")
    _logger.debug(f"{site}: wrote {path} ({len(blob)} bytes)")


def read_bytes(path: str, *, schema: str,
               site: str) -> Tuple[Optional[bytes], str]:
    """Validated read: ``(payload, "ok")``, ``(None, "missing")``,
    ``(raw_blob, "legacy")`` for a file without an envelope, or
    ``(None, "corrupt")``."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        counter_inc("store.misses")
        return None, "missing"
    try:
        payload, _ = decode_envelope(blob, schema)
    except StoreCorrupt as e:
        counter_inc("store.corrupt")
        _logger.warning(f"{site}: corrupt artifact {path} ({e})")
        return None, "corrupt"
    except ValueError:
        counter_inc("store.legacy")
        return blob, "legacy"
    counter_inc("store.reads")
    return payload, "ok"


def write_jsonl(path: str, rows: Iterable[Any], *, schema: str,
                site: str) -> None:
    # one encoder for every line: the bytes of json.dumps(r, default=str)
    body = "\n".join(map(json.JSONEncoder(default=str).encode, rows))
    body += "\n" if body else ""
    write_bytes(path, body.encode("utf-8"), schema=schema, site=site)


def read_jsonl(path: str, *, schema: str,
               site: str) -> Tuple[Optional[List[Any]], str]:
    payload, status = read_bytes(path, schema=schema, site=site)
    if payload is None:
        return None, status
    try:
        lines = payload.decode("utf-8").splitlines()
        return [json.loads(ln) for ln in lines
                if ln.strip() and not ln.startswith("#")], status
    except (ValueError, UnicodeDecodeError) as e:
        counter_inc("store.corrupt")
        _logger.warning(f"{site}: jsonl payload of {path} unparsable ({e})")
        return None, "corrupt"
