from .synthetic import ClassificationData, histogram, make_classification_data
