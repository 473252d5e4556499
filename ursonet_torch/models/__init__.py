"""The UrsoNet model: ResNet backbone, bottleneck conv, pose heads."""
