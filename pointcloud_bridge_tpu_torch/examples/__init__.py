"""Runnable examples of the port (``python -m
pointcloud_bridge_tpu_torch.examples.<name>``): the train -> vote ->
measure pipeline and the large-scene streaming serve."""
