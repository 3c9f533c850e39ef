from .fcn_head import FCNHead  # noqa: F401
from .flow_head import FlowAggregationHead  # noqa: F401
from .resnet import ResNet  # noqa: F401
