"""Host networking tier: wire codecs, peer picking, peer client/batcher.

The client API and the cross-host peer traffic ride gRPC here.
"""
