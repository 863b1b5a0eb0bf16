"""Launch drivers of the port: step builders and the monitored serving driver."""
