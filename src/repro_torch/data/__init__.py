from .synthetic import TokenStream, host_shard, make_batch

__all__ = ["TokenStream", "make_batch", "host_shard"]
