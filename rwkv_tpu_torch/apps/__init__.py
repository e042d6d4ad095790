"""The example apps: HTTP server, chat, storygen, vectordb (counterpart of
rwkv_tpu/apps/)."""
