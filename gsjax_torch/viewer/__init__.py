"""Live viewers: the SIBR remote-viewer server of a training run
(`network_gui`), the browser viewer (`web`) and the native client
(`client`, `cpp/sibr_client.cpp`)."""
