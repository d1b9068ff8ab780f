"""Experimental APIs: state introspection, internal KV.

Analog of /root/reference/python/ray/experimental/.
"""
