"""The data path of the torch port: stores, the dataset, the host loader and the card-resident sampler."""
