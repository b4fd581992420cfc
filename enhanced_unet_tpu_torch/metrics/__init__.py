"""Metrics of the PyTorch port: semantic IoU and Dice from confusion
matrices built on the device (`metrics.semantic`), and on the host the
instance metrics (`metrics.instance`), COCO mAP (`metrics.coco`) and
viability (`metrics.viability`)."""
