"""The OSD's data-path helpers, ported one slice at a time.

ec_util  EC stripe math (stripe_info_t) and the per-shard checksum HashInfo:
         pure numpy and zlib, no device code.
"""
