"""flexflow_tpu_torch.keras — the Keras-compatible frontend, the port of
``flexflow_tpu/keras`` (reference ``python/flexflow/keras``): Sequential
and functional ``Model``, the layer, optimizer and callback surfaces, and
the accuracy-verification callbacks the reference's example suite uses
as its test harness."""

from . import callbacks, datasets, layers, optimizers, preprocessing
from .callbacks import (Callback, EarlyStopping, EpochVerifyMetrics,
                        LearningRateScheduler, ModelAccuracy,
                        ModelCheckpoint, VerifyMetrics)
from .layers import (Activation, Add, AveragePooling2D, BatchNormalization,
                     Concatenate, Conv2D, Dense, Dropout, Embedding, Flatten,
                     Input, InputLayer, LayerNormalization, MaxPooling2D,
                     Multiply, Softmax, Subtract)
from .models import BaseModel, Model, Sequential
from .optimizers import SGD, Adam
